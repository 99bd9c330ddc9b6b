"""The loops a traffic mix can name: ``loops/<loop>.py``, each with
``setup``, ``call``, ``window``, ``layer_spans``, ``ray_stats`` and
``check``."""
