"""dp x mp parallelism over one process a device: the mesh and its
collectives (``mesh.py``) and the row-sharded recurrences
(``model_parallel.py``)."""

from urgent2026_challenge_track1_tpu_torch.parallel.mesh import (  # noqa: F401
    Mesh,
    make_mesh,
    parse_mesh_shape,
)
