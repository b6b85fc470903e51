"""Import side-effect module: registers every assigned architecture."""
from . import (  # noqa: F401
    granite_moe_3b_a800m,
    h2o_danube_1_8b,
    hubert_xlarge,
    internvl2_1b,
    mamba2_370m,
    mistral_nemo_12b,
    qwen2_5_3b,
    qwen2_moe_a2_7b,
    recurrentgemma_2b,
    tinyllama_1_1b,
)
