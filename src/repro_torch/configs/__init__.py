"""Workload configurations of the port: the lineitem schema and its
seeded numpy generator (``paper_vcs``), and the architecture registry of
the model stack (one module per architecture the port serves)."""
from .base import (ArchConfig, MoECfg, SSMCfg, all_arch_names,  # noqa: F401
                   get_config)

from . import (deepseek_7b, granite_20b, internlm2_1_8b,  # noqa: F401,E402
               mixtral_8x7b, phi3_5_moe_42b, qwen1_5_0_5b)

ALL = True  # marker: all configs registered
