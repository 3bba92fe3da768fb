"""The paper's own model configurations (§4, Table 2).

BERT-style MLM encoders; every OTHER feed-forward layer is replaced with a
MoE layer of 128 experts, top-1 (Switch-style). ``smile-*`` uses bi-level
routing with the additive LB loss (alpha = beta = 0.005); ``switch-*`` is the
one-hop baseline (alpha = 0.01). ``bert-*`` are the dense FLOP/param-matched
baselines from Table 1.

Sizes (Table 2): 3.7B (12L/768/3072), 13B (24L/1024/4096),
48B (36L/1600/6400) — all with 128 experts.
"""
import dataclasses

from repro_torch.common.config import ModelConfig, MoEConfig


def _moe(router: str) -> MoEConfig:
    return MoEConfig(
        num_experts=128,
        top_k=1,
        d_ff_expert=0,               # filled per-size below
        capacity_factor=2.0,         # paper §4.2
        router=router,
        lb_alpha=0.01 if router == "switch" else 0.005,
        lb_beta=0.005,
        every_n_layers=2,
    )


def _base(name, L, d, H, ff, moe_router=None) -> ModelConfig:
    moe = None
    if moe_router:
        moe = dataclasses.replace(_moe(moe_router), d_ff_expert=ff)
    return ModelConfig(
        name=name,
        arch_type="mlm",
        num_layers=L,
        d_model=d,
        num_heads=H,
        num_kv_heads=H,
        d_ff=ff,
        vocab_size=32128,            # T5 vocabulary (paper §4.1)
        attention="full",
        causal=False,                # bidirectional (masked LM)
        use_rope=False,              # BERT-style learned-free: plain abs? keep rope off
        act="gelu",
        glu=False,
        norm="layernorm",
        moe=moe,
        source="SMILE paper §4 / Table 2",
    )


CONFIGS = {
    # Table 1/Fig. 6 models (BERT_base backbone, 128 experts -> 3.7B total)
    "smile-3.7b": _base("smile-3.7b", 12, 768, 12, 3072, "smile"),
    "switch-3.7b": _base("switch-3.7b", 12, 768, 12, 3072, "switch"),
    "bert-110m": _base("bert-110m", 12, 768, 12, 3072),
    "bert-3.7b": _base("bert-3.7b", 12, 2560, 40, 10240),   # param-matched dense
    # Table 2 scaling sizes
    "smile-13b": _base("smile-13b", 24, 1024, 16, 4096, "smile"),
    "smile-48b": _base("smile-48b", 36, 1600, 32, 6400, "smile"),
}

_red_moe_smile = MoEConfig(num_experts=4, top_k=1, d_ff_expert=128,
                           capacity_factor=4.0, router="smile",
                           lb_alpha=0.005, lb_beta=0.005, every_n_layers=2,
                           grid=(2, 2))
_red_moe_switch = MoEConfig(num_experts=4, top_k=1, d_ff_expert=128,
                            capacity_factor=4.0, router="switch",
                            lb_alpha=0.01, every_n_layers=2, grid=(2, 2))

REDUCEDS = {
    "smile-3.7b": CONFIGS["smile-3.7b"].replace(
        num_layers=2, d_model=256, num_heads=4, num_kv_heads=4, d_ff=512,
        vocab_size=512, moe=_red_moe_smile),
    "switch-3.7b": CONFIGS["switch-3.7b"].replace(
        num_layers=2, d_model=256, num_heads=4, num_kv_heads=4, d_ff=512,
        vocab_size=512, moe=_red_moe_switch),
    "bert-110m": CONFIGS["bert-110m"].replace(
        num_layers=2, d_model=256, num_heads=4, num_kv_heads=4, d_ff=512,
        vocab_size=512),
    "bert-3.7b": CONFIGS["bert-3.7b"].replace(
        num_layers=2, d_model=256, num_heads=4, num_kv_heads=4, d_ff=512,
        vocab_size=512),
    "smile-13b": CONFIGS["smile-13b"].replace(
        num_layers=2, d_model=256, num_heads=4, num_kv_heads=4, d_ff=512,
        vocab_size=512, moe=_red_moe_smile),
    "smile-48b": CONFIGS["smile-48b"].replace(
        num_layers=2, d_model=256, num_heads=4, num_kv_heads=4, d_ff=512,
        vocab_size=512, moe=_red_moe_smile),
}
