"""The ``transformer`` family: pre-norm attention blocks, each with a
dense FFN or a MoE layer, a final norm and an fp32 head, as the port's
``models/transformer.py`` lays them out and runs them.

A family module gives what the benchmark needs of a model: its leaves in
draw order and the port's parameter tree made of them (:func:`leaves`,
:func:`make_tree`), the plain reference's training loss and served
logits (float32, no kernels, nothing of the program), and the model
FLOPs of one token (:func:`token_flops`).  The MoE layer is the router's
(``bench/reference/routers/<moe.router>.py``).

The stages follow the port's ``build_stages``: ``first_dense_layers``
dense blocks, then a ``pair`` stage (every second FFN a MoE layer: the
stage runs its dense blocks, then its MoE blocks) or a ``moe`` stage
(every FFN a MoE layer); the port has no other layout.  Departures from
the published models, as the port runs them, are each configuration's
``assumed``: the paper's encoder runs its six dense blocks before its six
MoE blocks; qwen3-moe routes bi-level over a (16, 8) grid where the
published model routes top-8 flat, and has no q/k norm.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import torch
import torch.nn.functional as F

from bench.core import plugins
from bench.core.weights import Leaf
from bench.reference import moe as MOE
from bench.reference.ops import attention, dense_ffn, norm


def stages(doc: Dict) -> List[Tuple[str, int]]:
    """``(kind, repeats)`` of each stage, in run order."""
    m, e = doc["model"], doc.get("moe") or {}
    L = m["num_layers"]
    if not e.get("num_experts"):
        return [("dense", L)]
    fd = e.get("first_dense_layers", 0)
    out = [("dense", fd)] if fd else []
    rest, every = L - fd, e["every_n_layers"]
    if every == 2 and rest % 2 == 0:
        return out + [("pair", rest // 2)]
    if every == 1:
        return out + [("moe", rest)]
    raise ValueError(f"every_n_layers {every} over {rest} layers: the "
                     f"port's stages pair one dense and one MoE block or "
                     f"run MoE blocks only")


def _slots(kind: str, repeats: int) -> List[Tuple[str, str]]:
    """``(slot in the stage's dict, block kind)`` of each block, in run
    order."""
    if kind == "pair":
        return [("dense", "dense")] * repeats + [("moe", "moe")] * repeats
    return [("blocks", kind)] * repeats


def _block_leaves(doc: Dict, kind: str):
    m = doc["model"]
    d, f = m["d_model"], m["d_ff"]
    H, KV = m["num_heads"], m["num_kv_heads"]
    hd = m.get("head_dim") or d // H
    ln = m["norm"] == "layernorm"
    out = [(("ln1", "scale"), (d,), 1.0, "ones")]
    if ln:
        out.append((("ln1", "bias"), (d,), 0.0, "zeros"))
    out += [(("attn", "wq"), (d, H, hd), d ** -0.5, "mm"),
            (("attn", "wk"), (d, KV, hd), d ** -0.5, "mm"),
            (("attn", "wv"), (d, KV, hd), d ** -0.5, "mm"),
            (("attn", "wo"), (H, hd, d), (H * hd) ** -0.5, "mm"),
            (("ln2", "scale"), (d,), 1.0, "ones")]
    if ln:
        out.append((("ln2", "bias"), (d,), 0.0, "zeros"))
    if kind == "dense":
        out += [(("ffn", "w1"), (d, f), d ** -0.5, "mm"),
                (("ffn", "w2"), (f, d), f ** -0.5, "mm")]
        if m["glu"]:
            out.append((("ffn", "w3"), (d, f), d ** -0.5, "mm"))
        return out
    return out + [(("moe",) + path, shape, scale, role) for path, shape,
                  scale, role in plugins.router(doc).leaves(doc)]


def leaves(doc: Dict) -> List[Leaf]:
    """Every leaf, in draw order.  A block's leaf is at ``("stages",
    stage, slot, index) + path``; its group (the stacked leaf LAMB and
    the checks take a norm over) is the slot's kind and the path, with
    the stage's number after the first stage."""
    m = doc["model"]
    V, d = m["vocab_size"], m["d_model"]
    ln = m["norm"] == "layernorm"
    out = [Leaf("embed.table", -1, ("embed", "table"), (V, d), 0.02, "fp32"),
           Leaf("lm_head.w", -1, ("lm_head", "w"), (V, d), 0.02, "fp32")]
    layer = 0
    for si, (kind, reps) in enumerate(stages(doc)):
        seen: Dict[str, int] = {}
        for slot, bkind in _slots(kind, reps):
            j = seen[slot] = seen.get(slot, -1) + 1
            tag = bkind if si == 0 else f"{bkind}{si}"
            for path, shape, scale, role in _block_leaves(doc, bkind):
                out.append(Leaf(f"{tag}." + ".".join(path), layer,
                                ("stages", si, slot, j) + path, shape,
                                scale, role))
            layer += 1
    out.append(Leaf("final_norm.scale", -1, ("final_norm", "scale"), (d,),
                    1.0, "ones"))
    if ln:
        out.append(Leaf("final_norm.bias", -1, ("final_norm", "bias"), (d,),
                        0.0, "zeros"))
    return out


def make_tree(doc: Dict, drawn) -> Dict:
    """The port's parameter tree of the drawn ``(leaf, tensor)`` pairs."""
    tree: Dict = {}
    st = [dict() for _ in stages(doc)]
    for leaf, t in drawn:
        if leaf.path[0] == "stages":
            _, si, slot, j = leaf.path[:4]
            blocks = st[si].setdefault(slot, [])
            while len(blocks) <= j:
                blocks.append({})
            node, path = blocks[j], leaf.path[4:]
        else:
            node, path = tree, leaf.path
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = t
    tree["stages"] = tuple(st)
    return tree


def layers(tree: Dict, doc: Dict) -> List[Tuple[str, Dict]]:
    """``(kind, block)`` in run order."""
    out = []
    for (kind, reps), st in zip(stages(doc), tree["stages"]):
        seen: Dict[str, int] = {}
        for slot, bkind in _slots(kind, reps):
            j = seen[slot] = seen.get(slot, -1) + 1
            out.append((bkind, st[slot][j]))
    return out


def _ffn(kind: str, p: Dict, h: torch.Tensor, doc: Dict, quant):
    """(t, d) -> (t, d) and the balance loss."""
    if kind == "dense":
        return dense_ffn(p["ffn"], h, doc["model"], quant), h.new_zeros(())
    return plugins.router(doc).forward(p["moe"], h, doc["model"],
                                       doc["moe"], quant)


def train_loss(tree: Dict, tokens, labels, doc: Dict, quant=None
               ) -> torch.Tensor:
    """The training loss: the masked cross-entropy's mean over the targets
    plus every MoE layer's balance losses."""
    m = doc["model"]
    x = tree["embed"]["table"][tokens.long()].float()
    lb = x.new_zeros(())
    for kind, p in layers(tree, doc):
        x = x + attention(p["attn"], norm(p["ln1"], x, m["norm"]), m, quant)
        h = norm(p["ln2"], x, m["norm"])
        B, T, d = h.shape
        y, l = _ffn(kind, p, h.reshape(B * T, d), doc, quant)
        x = x + y.reshape(B, T, d)
        lb = lb + l
    x = norm(tree["final_norm"], x, m["norm"])
    logits = x @ tree["lm_head"]["w"].float().t()
    ce = F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                         labels.reshape(-1).long(), ignore_index=-1,
                         reduction="sum")
    cnt = (labels != -1).sum().clamp(min=1)
    return ce / cnt + lb


@torch.no_grad()
def served_logits(tree: Dict, seqs: List[torch.Tensor], first: List[int],
                  doc: Dict, quant=None) -> List[torch.Tensor]:
    """fp32 logits of each sequence ``seqs[i]`` (token ids, one sequence
    each, run whole and causally) at its positions ``first[i]`` onward.
    The sequences run together layer by layer: attention one sequence at a
    time, the FFN or MoE layer over all their tokens at once."""
    m = doc["model"]
    xs = [tree["embed"]["table"][s.long()].float()[None] for s in seqs]
    for kind, p in layers(tree, doc):
        xs = [x + attention(p["attn"], norm(p["ln1"], x, m["norm"]), m,
                            quant) for x in xs]
        hs = [norm(p["ln2"], x, m["norm"])[0] for x in xs]
        y, _ = _ffn(kind, p, torch.cat(hs), doc, quant)
        out, off = [], 0
        for x in xs:
            T = x.shape[1]
            out.append(x + y[off:off + T][None])
            off += T
        xs = out
    head = tree["lm_head"]["w"]
    res = []
    for x, f in zip(xs, first):
        h = norm(tree["final_norm"], x[0, f:], m["norm"])
        res.append(h @ head.float().t())
    return res


def token_flops(doc: Dict, keys: float, head: bool) -> float:
    """Forward FLOPs of one token that attends to ``keys`` keys: two per
    multiply-add of the blocks' matmuls (its top-k experts only), attention's
    ``QK^T`` and ``PV``, and the LM head where its logits are used."""
    m = doc["model"]
    d, H, KV = m["d_model"], m["num_heads"], m["num_kv_heads"]
    hd = m.get("head_dim") or d // H
    attn = d * H * hd + 2 * d * KV * hd + H * hd * d
    dense = attn + (3 if m["glu"] else 2) * d * m["d_ff"]
    kinds = [k for _, k in layers_of(doc)]
    f = 0.0
    for k in kinds:
        if k == "dense":
            f += 2.0 * dense
        else:
            f += 2.0 * (attn + plugins.router(doc).router_params(doc)
                        + MOE.expert_params(doc))
    f += 4.0 * keys * H * hd * len(kinds)
    if head:
        f += 2.0 * m["vocab_size"] * d
    return f


def layers_of(doc: Dict) -> List[Tuple[str, str]]:
    """``(slot, block kind)`` of every layer, in run order."""
    return [s for kind, reps in stages(doc) for s in _slots(kind, reps)]
