"""llama3-405b [dense] — GQA, 128k vocab. [arXiv:2407.21783]

126L d_model=16384 128H (GQA kv=8) d_ff=53248 vocab=128256.
"""
from repro_torch.common.config import ModelConfig

CONFIG = ModelConfig(
    name="llama3-405b",
    arch_type="dense",
    num_layers=126,
    d_model=16384,
    num_heads=128,
    num_kv_heads=8,
    d_ff=53248,
    vocab_size=128256,
    attention="full",
    act="silu",
    glu=True,
    norm="rmsnorm",
    rope_theta=500000.0,
    source="arXiv:2407.21783",
)

REDUCED = CONFIG.replace(num_layers=2, d_model=256, num_heads=8,
                         num_kv_heads=2, d_ff=512, vocab_size=512)
