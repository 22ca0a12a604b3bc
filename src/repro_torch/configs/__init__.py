"""Workload configurations of the port: the lineitem schema and its
seeded numpy generator (``paper_vcs``), and the architecture registry of
the model stack (one module per architecture the port serves)."""
from .base import (ArchConfig, MoECfg, ShapeCfg, SSMCfg,  # noqa: F401
                   all_arch_names, first_layers, get_config, period_slots)

from . import (deepseek_7b, granite_20b, internlm2_1_8b,  # noqa: F401,E402
               jamba_1_5_large_398b, llama_3_2_vision_90b, mixtral_8x7b,
               phi3_5_moe_42b, qwen1_5_0_5b, rwkv6_7b, whisper_medium)

ALL = True  # marker: all configs registered
