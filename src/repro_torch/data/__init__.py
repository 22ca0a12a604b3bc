from .tokens import (TOKENS_SCHEMA, PinnedDataset, add_samples,  # noqa
                     create_token_table, decode_tokens, synth_corpus)
from .pipeline import BatchPipeline, PipelineCfg  # noqa
