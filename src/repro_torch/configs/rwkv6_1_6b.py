"""rwkv6-1.6b [ssm] — Finch, data-dependent decay. [arXiv:2404.05892]

24L d_model=2048 (attention-free) d_ff=7168 vocab=65536.
"""
from repro_torch.common.config import ModelConfig, RWKVConfig

CONFIG = ModelConfig(
    name="rwkv6-1.6b",
    arch_type="ssm",
    num_layers=24,
    d_model=2048,
    num_heads=32,                 # d_model / rwkv head_dim
    num_kv_heads=32,
    d_ff=7168,
    vocab_size=65536,
    attention="none",
    use_rope=False,
    act="relu",
    glu=False,
    norm="layernorm",
    rwkv=RWKVConfig(head_dim=64, decay_lora=64, mix_lora=32),
    source="arXiv:2404.05892",
)

REDUCED = CONFIG.replace(num_layers=2, d_model=256, num_heads=4,
                         num_kv_heads=4, d_ff=512, vocab_size=512,
                         rwkv=RWKVConfig(head_dim=64, decay_lora=16,
                                         mix_lora=8))
