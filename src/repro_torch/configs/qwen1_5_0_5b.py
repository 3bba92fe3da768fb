"""qwen1.5-0.5b [dense] — QKV bias. [hf:Qwen/Qwen1.5-0.5B]

24L d_model=1024 16H (GQA kv=16) d_ff=2816 vocab=151936.
"""
from repro_torch.common.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen1.5-0.5b",
    arch_type="dense",
    num_layers=24,
    d_model=1024,
    num_heads=16,
    num_kv_heads=16,
    d_ff=2816,
    vocab_size=151936,
    attention="full",
    qkv_bias=True,
    act="silu",
    glu=True,
    norm="rmsnorm",
    rope_theta=1000000.0,
    tie_embeddings=True,
    source="hf:Qwen/Qwen1.5-0.5B",
)

REDUCED = CONFIG.replace(num_layers=2, d_model=256, num_heads=4,
                         num_kv_heads=4, d_ff=512, vocab_size=512)
