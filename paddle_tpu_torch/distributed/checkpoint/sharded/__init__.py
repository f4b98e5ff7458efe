"""The reference's sharded checkpoint format, read and written by the port
(single device): ``save_sharded(state, dir)`` writes one piece per tensor
under an atomic tmp+rename+fsync publish; ``load_sharded`` and
``load_sharded_like`` assemble any piece layout a JAX save wrote, with
JAX's float casts; ``values_like`` holds a dict to the same checks and
casts. ``manifest.verify_dir`` audits a directory."""
from .engine import load_sharded, load_sharded_like, save_sharded, values_like
from .manifest import FORMAT, MANIFEST_NAME, read_manifest, verify_dir

__all__ = ["FORMAT", "MANIFEST_NAME", "load_sharded", "load_sharded_like",
           "read_manifest", "save_sharded", "values_like", "verify_dir"]
