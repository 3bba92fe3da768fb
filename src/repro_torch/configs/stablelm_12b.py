"""stablelm-12b [dense]. [hf:stabilityai/stablelm-2-1_6b (family card)]

40L d_model=5120 32H (GQA kv=8) d_ff=13824 vocab=100352.
"""
from repro_torch.common.config import ModelConfig

CONFIG = ModelConfig(
    name="stablelm-12b",
    arch_type="dense",
    num_layers=40,
    d_model=5120,
    num_heads=32,
    num_kv_heads=8,
    d_ff=13824,
    vocab_size=100352,
    attention="full",
    act="silu",
    glu=True,
    norm="layernorm",
    rope_theta=10000.0,
    source="hf:stabilityai/stablelm-2-12b",
)

REDUCED = CONFIG.replace(num_layers=2, d_model=256, num_heads=4,
                         num_kv_heads=2, d_ff=512, vocab_size=512)
