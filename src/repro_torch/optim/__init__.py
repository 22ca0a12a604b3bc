from .adamw import (AdamWCfg, OptState, apply_updates,  # noqa: F401
                    global_norm, init_opt_state, lr_at)
