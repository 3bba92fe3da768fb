"""The check fails where the timed path is broken underneath: a step
that leaves its state unchanged, half of each batch left out, and a
served token altered where it is produced."""
import pytest

from bench.tests._run import run


def test_state_left_unchanged(monkeypatch):
    import repro_torch.optim as O
    real = O.make_optimizer

    def frozen(*a, **k):
        return real(*a, **k)._replace(
            update=lambda params, state, lr, shard_axes=None: state)
    monkeypatch.setattr(O, "make_optimizer", frozen)
    r = run("smile3.7b-train-b16s128", monkeypatch)
    assert not r["correct"]
    assert r["checks"]["change_gap"]["value"] == pytest.approx(1.0)


def test_half_the_batch(monkeypatch):
    from repro_torch.train import step as ST
    real_build = ST.build_train_step

    def half(*a, **k):
        fn = real_build(*a, **k)

        def step(params, state, batch, i, sent=None):
            n = len(batch["tokens"]) // 2
            return fn(params, state, {k: v[:n] for k, v in batch.items()}, i)
        return step
    monkeypatch.setattr(ST, "build_train_step", half)
    r = run("smile3.7b-train-b16s128", monkeypatch)
    assert not r["correct"]


def test_served_token_altered(monkeypatch):
    from repro_torch.serve.engine import Engine
    real = Engine._run

    def altered(self, key, inputs):
        out = real(self, key, inputs)
        if key == "decode":
            out = (out + 1) % self.cfg.vocab_size
        return out
    monkeypatch.setattr(Engine, "_run", altered)
    r = run("qwen3moe-chat", monkeypatch, seconds=2.0)
    assert not r["correct"]
