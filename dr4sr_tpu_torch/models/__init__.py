from dr4sr_tpu_torch.models.registry import get_model_class, register_model  # noqa: F401
from dr4sr_tpu_torch.models import (  # noqa: F401
    cl4srec, deepseek_v2, fmlp, gnn, graph_cl, gru4rec, iclrec, metamodel, sasrec)
