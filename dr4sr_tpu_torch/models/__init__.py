from dr4sr_tpu_torch.models.registry import get_model_class, register_model  # noqa: F401
from dr4sr_tpu_torch.models import cl4srec, fmlp, gru4rec, sasrec  # noqa: F401
