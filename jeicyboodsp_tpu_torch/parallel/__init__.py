from jeicyboodsp_tpu_torch.parallel.mesh import make_mesh  # noqa: F401
from jeicyboodsp_tpu_torch.parallel import speech_sharded  # noqa: F401
