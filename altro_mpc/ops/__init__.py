from .dispatch import use_kernel
from .riccati import batched_backward
from .rollout import batched_ls_rollout
