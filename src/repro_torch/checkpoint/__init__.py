from .vcs_ckpt import CKPT_SCHEMA, VcsCheckpointer  # noqa
from .manager import CheckpointManager  # noqa
