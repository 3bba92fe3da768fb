"""deepseek-v3-671b [moe] — MLA, 1 shared + 256 routed top-8, MTP.

61L d_model=7168 128H (MLA) moe d_ff=2048 vocab=129280, 256 experts top-8.
[arXiv:2412.19437]
"""
from repro_torch.common.config import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="deepseek-v3-671b",
    arch_type="moe",
    num_layers=61,
    d_model=7168,
    num_heads=128,
    num_kv_heads=128,
    head_dim=192,                    # qk_nope(128) + qk_rope(64)
    d_ff=18432,                      # dense FFN in the first 3 layers
    vocab_size=129280,
    attention="mla",
    q_lora_rank=1536,
    kv_lora_rank=512,
    qk_nope_head_dim=128,
    qk_rope_head_dim=64,
    v_head_dim=128,
    act="silu",
    glu=True,
    norm="rmsnorm",
    rope_theta=10000.0,
    mtp_depth=1,
    moe=MoEConfig(
        num_experts=256,
        top_k=8,
        top_g=4,                     # bi-level: 4 nodes x 2 local experts
        renorm_gates=True,
        d_ff_expert=2048,
        num_shared_experts=1,
        capacity_factor=2.0,
        router="smile",              # the paper's technique, first-class
        lb_alpha=0.005,
        lb_beta=0.005,
        every_n_layers=1,
        first_dense_layers=3,
    ),
    source="arXiv:2412.19437",
)

REDUCED = CONFIG.replace(
    num_layers=2,
    d_model=256,
    num_heads=4,
    num_kv_heads=4,
    head_dim=48,
    d_ff=512,
    vocab_size=512,
    q_lora_rank=64,
    kv_lora_rank=32,
    qk_nope_head_dim=32,
    qk_rope_head_dim=16,
    v_head_dim=32,
    mtp_depth=1,
    moe=CONFIG.moe and CONFIG.moe.__class__(
        num_experts=4, top_k=2, top_g=2, renorm_gates=True, d_ff_expert=128,
        num_shared_experts=1, capacity_factor=4.0, router="smile",
        lb_alpha=0.005, lb_beta=0.005, every_n_layers=1,
        first_dense_layers=1, grid=(2, 2)),
)
