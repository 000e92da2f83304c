from pararealml_tpu_torch.utils.checkpoint import load_pytree, save_pytree
from pararealml_tpu_torch.utils.rand import SEEDS, set_random_seed

__all__ = ["SEEDS", "set_random_seed", "save_pytree", "load_pytree"]
