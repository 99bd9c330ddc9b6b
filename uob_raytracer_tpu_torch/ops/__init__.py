from .math3 import det3, dot3, cross3, normalize3  # noqa: F401
from .rng import xorshift, crush, shadow_seed  # noqa: F401
from .camera import rotation_matrix, gen_primary_rays  # noqa: F401
from .intersect import DeviceScene, Hit, prepare_scene, intersect, in_shadow  # noqa: F401
from .shading import direct_light, shade  # noqa: F401
from .image import pack_argb, save_bmp, to_u8  # noqa: F401
