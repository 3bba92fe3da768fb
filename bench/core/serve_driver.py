"""A serving cell: the port's continuous-batching ``Engine`` driven through
``submit()`` and ``step()``.

Set-up makes the weights, builds the engine and warms up every prefill
bucket and the decode step (each a CUDA graph on the card) with one short
request a bucket.  Then the load runs:

* open loop (``kind: open``): requests are submitted when due, whatever is
  in flight; a ramp brings the engine to steady state, the window counts
  the requests due inside it, and the tail keeps arriving while those
  drain, until every counted request is done or ``drain_cap_s`` passes (a
  request unfinished then has failed).  Each request is timed from when it
  was due; how late the loop submitted it is reported beside.
* closed loop (``kind: closed``): ``clients`` callers each send their next
  request when the last one finishes; the window counts the tokens
  generated inside it, and the requests it finished.

Every request is greedy.  Once the window has closed and the engine is
freed, a sample of finished requests drawn from the seed (the one with the
most tokens always in it) goes through the reference, whole, and each
served token's logit is held to the reference's best at its position.
"""
from __future__ import annotations

import time
from typing import Dict, List

import numpy as np
import torch
from torch.profiler import record_function

from bench.core import flops as FL
from bench.core import plugins
from bench.core import traffic as TR
from bench.core import weights as W
from bench.core.spec import Cell
from bench.core.train_driver import _free, port_config

FAR = 0.1       # logits below the reference's best: past a near tie


def _engine(cell: Cell, tree, device):
    from repro_torch.common.config import ServeConfig
    from repro_torch.serve.engine import Engine
    from repro_torch.sharding.plan import single_device_plan
    e = cell.load["engine"]
    scfg = ServeConfig(cache_len=e["cache_len"], page_size=e["page_size"],
                       pool_pages=e.get("pool_pages", 0),
                       n_slots=e["n_slots"],
                       prefill_buckets=e["prefill_buckets"],
                       admit_policy=e.get("admit_policy", "fcfs"))
    return Engine(tree, port_config(cell.config), single_device_plan(),
                  serve=scfg)


def _warm(eng, vocab: int) -> None:
    """One short request a prefill bucket, drained: every step this cell
    runs is built and captured before the window."""
    rng = np.random.default_rng(0)
    for b in eng.buckets:
        eng.submit(rng.integers(TR.FIRST_ID, vocab, size=b).astype(np.int32),
                   max_new_tokens=2)
    eng.run()


def _p95(vals: List[float]) -> float:
    """Nearest-rank 95th percentile."""
    s = sorted(vals)
    return s[max(0, int(np.ceil(0.95 * len(s))) - 1)]


class _Ticks:
    """Start and end of every engine step the driver makes."""

    def __init__(self):
        self.t: List[tuple] = []

    def step(self, eng, span: bool):
        a = time.monotonic()
        if span:
            with record_function("bench.engine_step"):
                eng.step()
        else:
            eng.step()
        self.t.append((a, time.monotonic()))

    def index(self, when: float) -> int:
        """The step during which ``when`` fell."""
        lo = 0
        for i, (a, b) in enumerate(self.t):
            if a <= when <= b:
                return i
            if a > when:
                return max(0, i - 1)
            lo = i
        return lo


def _traced_flops(doc: Dict, reqs, ticks: _Ticks, first: int, last: int,
                  bucket_max: int) -> float:
    """Model FLOPs of the work the engine did in steps ``first..last``:
    each decoded token, and each prefill chunk (the step it ran in
    counted back from the step that gave the request's first token)."""
    a, b = ticks.t[first][0], ticks.t[last][1]
    tot = 0.0
    for r in reqs:
        P = len(r.prompt)
        for i, t in enumerate(r.t_tokens[1:], start=1):
            if a <= t <= b:
                tot += FL.decode_flops(doc, P + i - 1)
        if not r.t_tokens:
            continue
        n_chunks = -(-P // bucket_max)
        end = ticks.index(r.t_first)
        for c in range(n_chunks):
            k = end - (n_chunks - 1 - c)
            if first <= k <= last:
                s = c * bucket_max
                tot += FL.prefill_flops(doc, s, min(bucket_max, P - s),
                                        c == n_chunks - 1)
    return tot


def prepare(cell: Cell, seed: int, device):
    """The weights, the engine over them, every step warmed up."""
    doc = cell.config
    tree, drawn = W.make(doc, seed, device,
                         getattr(torch, doc["model"]["dtype"]))
    eng = _engine(cell, tree, device)
    _warm(eng, doc["model"]["vocab_size"])
    if device.type == "cuda":
        torch.cuda.synchronize()
    return tree, drawn, eng


def make_queue(mix: Dict, seed: int, seconds: float, vocab: int):
    if mix["kind"] == "open":
        return TR.open_loop(mix, float(mix["rate_per_s"]), seed, vocab,
                            {"ramp": float(mix["ramp_s"]), "window": seconds,
                             "tail": float(mix["drain_cap_s"])})
    return TR.closed_queue(mix, int(mix["clients"]), int(mix.get("blocks", 8)),
                           seed, vocab)


class Drive:
    """One pass of the load through the engine (see the module's text)."""

    def __init__(self, eng, mix: Dict, queue, seconds: float,
                 trace: bool = False):
        from bench.core import trace as TRC
        self.ticks = _Ticks()
        self.late: List[float] = []
        self.due_of: Dict[int, float] = {}
        self.counted: List[int] = []
        self.traced, self.window = None, None
        self.tr_first, self.tr_last = -1, -1
        ramp, cap = float(mix["ramp_s"]), float(mix["drain_cap_s"])
        n_trace = int(mix.get("trace_ticks", 10))
        opened = mix["kind"] == "open"
        self.t0 = t0 = time.monotonic()
        self.w0, self.w1 = w0, w1 = t0 + ramp, t0 + ramp + seconds
        nxt, live, win = 0, [], None

        def submit(r, due):
            uid = eng.submit(r.prompt, max_new_tokens=r.max_new)
            self.due_of[uid] = due
            self.late.append(eng.requests[uid].t_submit - due)
            return uid

        if not opened:
            for _ in range(min(int(mix["clients"]), len(queue))):
                live.append(submit(queue[nxt], t0))
                nxt += 1
        while True:
            now = time.monotonic()
            if opened:
                while nxt < len(queue) and t0 + queue[nxt].due <= now:
                    r = queue[nxt]
                    uid = submit(r, t0 + r.due)
                    if r.phase == "window":
                        self.counted.append(uid)
                    nxt += 1
                if now >= w1 and all(u in eng.finished for u in self.counted):
                    break
                if now >= w1 + cap:
                    break
            else:
                if now >= w1:
                    break
                for i, uid in enumerate(live):
                    if uid in eng.finished and nxt < len(queue):
                        live[i] = submit(queue[nxt], now)
                        nxt += 1
            if not eng.busy:
                if opened and nxt < len(queue):
                    time.sleep(max(0.0, min(0.002, t0 + queue[nxt].due
                                            - time.monotonic())))
                    continue
                break
            if (trace and win is None and self.tr_first < 0
                    and now >= w0 + seconds / 3):
                win = TRC.Window(torch).__enter__()
                self.tr_first = len(self.ticks.t)
            self.ticks.step(eng, win is not None)
            if win is not None and (len(self.ticks.t) - self.tr_first
                                    >= n_trace):
                win = self._close(win)
        if win is not None:
            self._close(win)
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        self.end = time.monotonic()

    def _close(self, win):
        self.tr_last = len(self.ticks.t) - 1
        win.__exit__(None, None, None)
        self.window = win
        return None

    def collect(self) -> None:
        """The traced window's trace, read once the load has stopped."""
        if self.window is not None:
            self.traced = self.window.collect()
            self.window = None

    def open_stats(self, eng) -> Dict:
        """TTFT and TPOT p95 over the requests due in the window; one that
        never finished counts as waiting until the run gave up on it."""
        reqs, end = eng.requests, self.end
        ttft, tpot = [], []
        for uid in self.counted:
            r, due = reqs[uid], self.due_of[uid]
            n = len(r.t_tokens)
            ttft.append(r.t_first - due if n else end - due)
            if uid in eng.finished:
                if n > 1:
                    tpot.append((r.t_tokens[-1] - r.t_first) / (n - 1))
            else:
                tpot.append((end - r.t_first) / max(1, n - 1) if n
                            else end - due)
        return {"attempted": len(self.counted),
                "failed": sum(1 for u in self.counted
                              if u not in eng.finished),
                "ttft_p95_s": _p95(ttft) if ttft else end - self.t0,
                "tpot_p95_s": _p95(tpot) if tpot else end - self.t0,
                "ttft_p50_s": float(np.median(ttft)) if ttft else 0.0,
                "pool": self.counted}

    def closed_stats(self, eng, seconds: float) -> Dict:
        reqs = eng.requests
        toks = sum(1 for r in reqs.values() for t in r.t_tokens
                   if self.w0 <= t < self.w1)
        fin = [u for u in eng.finished if u in self.due_of
               and self.w0 <= reqs[u].t_tokens[-1] < self.w1]
        return {"attempted": len(fin), "failed": 0,
                "tokens_per_s": toks / seconds if seconds else 0.0,
                "pool": fin}


def served_of(reqs, uids) -> List[tuple]:
    """``(tokens, prompt length, served tokens)`` of each request: the
    prompt with every served token but the last, as the reference reads
    them."""
    return [(np.concatenate([reqs[u].prompt,
                             np.asarray(reqs[u].generated[:-1], np.int32)]),
             len(reqs[u].prompt), list(reqs[u].generated)) for u in uids]


def run(cell: Cell, seed: int, seconds: float, trace: bool, device,
        clock) -> Dict:
    doc, mix = cell.config, cell.load
    tree, drawn, eng = prepare(cell, seed, device)
    queue = make_queue(mix, seed, seconds, doc["model"]["vocab_size"])
    setup_s = clock()
    d = Drive(eng, mix, queue, seconds, trace)
    d.collect()
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)
    res: Dict = {"setup_s": setup_s, "peak": peak,
                 "trace": d.traced, "late_s": d.late,
                 "ticks_traced": (d.tr_last - d.tr_first + 1)
                 if d.traced else 0, "wall_s": d.end - d.t0}
    res.update(d.open_stats(eng) if mix["kind"] == "open"
               else d.closed_stats(eng, seconds))
    reqs = eng.requests
    if d.traced is not None:
        res["traced_flops"] = _traced_flops(
            doc, list(reqs.values()), d.ticks, d.tr_first, d.tr_last,
            max(eng.buckets))
    served = served_of(reqs, _sample(reqs, eng.finished, res["pool"], seed,
                                     mix))
    # ---- free the engine (its pools and graphs), then the reference
    del eng, d
    _free(device)
    res["checks"] = logit_gaps(tree, doc, served, device)
    res["served"] = served
    res["served_tokens"] = sum(len(s[2]) for s in served)
    del tree, drawn
    _free(device)
    return res


def end_to_end(run: Dict) -> Dict[str, float]:
    """The run's end-to-end metrics: the tails of an open loop, the
    tokens a second of a closed one."""
    out = {"setup_s": run["setup_s"]}
    if "ttft_p95_s" in run:
        out["ttft_p95_ms"] = 1e3 * run["ttft_p95_s"]
        out["tpot_p95_ms"] = 1e3 * run["tpot_p95_s"]
    else:
        out["serve_tokens_per_s"] = run["tokens_per_s"]
    return out


def checks(run: Dict) -> Dict[str, float]:
    return dict(run["checks"])


def readings(cell: Cell, seed: int, seconds: float, device,
             control: bool) -> List[Dict]:
    """What the limits are set from: one run of the cell as ``run``
    makes it, its served tokens against the reference; with ``control``,
    the same prompts and tokens read by the reference at the next
    precision below (fp8 matmul operands and KV), the weights drawn again
    from the seed."""
    r = run(cell, seed, seconds, False, device, lambda: 0.0)
    out = [{"who": "program", "served_tokens": r["served_tokens"],
            **r["checks"]}]
    if control:
        doc = cell.config
        tree, drawn = W.make(doc, seed, device,
                             getattr(torch, doc["model"]["dtype"]))
        out.append({"who": "control:fp8kv",
                    "served_tokens": r["served_tokens"],
                    **logit_gaps(tree, doc, r["served"], device,
                                 quant="fp8kv")})
        del tree, drawn
        _free(device)
    return out


def _sample(reqs, finished, pool, seed: int, mix: Dict) -> List[int]:
    """Finished requests of ``pool`` drawn from the seed, the one with the
    most served tokens first, until ``sample_tokens`` served tokens or
    ``sample_max_tokens`` tokens in all."""
    done = [u for u in pool if u in finished]
    if not done:
        return []
    rng = np.random.default_rng(np.random.SeedSequence([seed, 9]))
    longest = max(done, key=lambda u: (len(reqs[u].generated), u))
    rest = [u for u in done if u != longest]
    rest = [rest[i] for i in rng.permutation(len(rest))]
    out, served, total = [longest], len(reqs[longest].generated), 0
    total = len(reqs[longest].prompt) + served
    for u in rest:
        if served >= mix["sample_tokens"]:
            break
        n = len(reqs[u].prompt) + len(reqs[u].generated)
        if total + n > mix["sample_max_tokens"]:
            continue
        out.append(u)
        served += len(reqs[u].generated)
        total += n
    return out


def logit_gaps(tree, doc, served, device, quant=None) -> Dict:
    """Each served token of the sample against the reference's logits at
    its position: ``logit_gap`` the widest gap between the reference's
    best logit and the served token's, ``logit_gap_mean`` the mean gap
    over the served tokens, ``top1_miss`` the share of them that are not
    the reference's best, ``far_miss`` the share more than ``FAR`` below
    it (past a near tie).  With ``quant`` (the control) the token at each
    position is the one the reference computed at that precision puts
    first."""
    from bench.reference.ops import fp32_exact
    if not served:
        return {"logit_gap": float("inf"), "logit_gap_mean": float("inf"),
                "top1_miss": 1.0, "far_miss": 1.0}
    logits_of = plugins.family(doc).served_logits
    seqs = [torch.as_tensor(s, device=device) for s, _, _ in served]
    first = [p - 1 for _, p, _ in served]
    with fp32_exact():
        ref = logits_of(tree, seqs, first, doc)
        if quant is not None:
            low = logits_of(tree, seqs, first, doc, quant=quant)
            picks = [lg.argmax(-1) for lg in low]
        else:
            picks = [torch.as_tensor(toks, device=device)
                     for _, _, toks in served]
    gaps = []
    for lg, pick in zip(ref, picks):
        best = lg.max(-1).values
        gaps.append(best - lg.gather(1, pick.long()[:, None])[:, 0])
    g = torch.cat(gaps)
    return {"logit_gap": float(g.max()), "logit_gap_mean": float(g.mean()),
            "top1_miss": float((g > 0).float().mean()),
            "far_miss": float((g > FAR).float().mean())}
