"""deepseek-coder-33b [dense] — llama-arch. [arXiv:2401.14196]

62L d_model=7168 56H (GQA kv=8) d_ff=19200 vocab=32256.
Note: 56 query heads are padded to 64 on tp=16 meshes (zero-init extra
heads; +2.2%% attention params) — see DESIGN.md §Simplifications.
"""
from repro_torch.common.config import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-coder-33b",
    arch_type="dense",
    num_layers=62,
    d_model=7168,
    num_heads=56,
    num_kv_heads=8,
    head_dim=128,
    d_ff=19200,
    vocab_size=32256,
    attention="full",
    act="silu",
    glu=True,
    norm="rmsnorm",
    rope_theta=100000.0,
    source="arXiv:2401.14196",
)

REDUCED = CONFIG.replace(num_layers=2, d_model=256, num_heads=7,
                         num_kv_heads=1, head_dim=32, d_ff=512,
                         vocab_size=512)
