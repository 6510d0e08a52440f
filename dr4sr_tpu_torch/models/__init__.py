from dr4sr_tpu_torch.models.registry import get_model_class, register_model  # noqa: F401
from dr4sr_tpu_torch.models import sasrec  # noqa: F401
