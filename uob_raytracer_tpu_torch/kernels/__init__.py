from .render_fwd import render_fused_raw, pack_scene, pack_shadow  # noqa: F401
