"""Device mesh, Megatron tensor-parallel sharding and the collectives, over
torch.distributed (port of paligemma_tpu/core/mesh.py).

JAX is single-controller: one program holds global arrays with
NamedShardings and XLA inserts the collectives. PyTorch runs one process
per card (SPMD), so here each rank holds its own slices and the model code
calls the collectives itself:

* ``Mesh`` names this rank's place in a ``data`` x ``model`` mesh, laid
  out as JAX's ``reshape(data, model)``: global rank ``i * model + j`` is
  data index ``i`` and model rank ``j``. ``group`` is the model group of
  its data index (the tensor-parallel collectives) and ``data_group`` the
  data group of its model rank (always gloo: only values the host reads
  back cross it, ``gather_data``). A rank of a data axis holds the rows of
  its own data shard: its share of a batch, of a serving engine's slots
  and of its page pool (runtime/engine, runtime/serving_paged).
* ``shard_params`` returns this rank's contiguous slices, by the JAX rules
  of ``_spec_for_leaf`` (here as tuples, one entry per dimension,
  ``"data"``, ``"model"`` or None; ``param_specs`` gives the tree of them,
  ``lora_specs``, ``batch_spec`` and ``kv_cache_specs`` the JAX helpers'
  other specs). A rank holds its slices, not a global array with a
  sharding, so the specs name which slice it holds. A rank holds whole
  heads: k and v are cut by KV heads (``kv_heads``, the tree's count of
  them, where k / v are narrower than q): ``kv_heads % model == 0`` gives
  each rank ``kv_heads / model`` of them, ``model % kv_heads == 0`` gives
  each rank the one KV head its query heads read (``model / kv_heads``
  ranks share it), any other layout raises (``kv_layout``). Two
  differences from the JAX rules: one KV head (Gemma's) is replicated, as
  the JAX decode kernels' ``repack_for_tp`` replicates it (JAX shards its
  columns under GSPMD), and SigLIP's patch embedding
  stays replicated (JAX shards its D; here the encoder blocks take the
  whole embedding as their input, which a D-sharded embedding would need
  gathered again). Weights are replicated over ``data``, except under
  FSDP: ``fsdp_param_specs`` (JAX's rule) adds one ``"data"`` dimension
  to every leaf of 64 KiB or more, and :class:`Fsdp` gathers such leaves
  at use (train/trainer ``fsdp=True``). 4-bit leaves (``w4``, ``s4``)
  shard as int8 ones do, the codebook replicated; a row-parallel split
  must fall on a quantization block. ``unshard_params`` / ``unshard_lora``
  are the inverses (every rank gets the whole tree: one card's layout).
* ``shard_lora`` slices a LoRA tree or a multi-LoRA bank the same way
  (the counterpart of JAX's ``lora_specs``): column-parallel targets (q,
  gate, up) take B's output columns with A whole, row-parallel ones (o,
  down) take A's input rows with B whole, so a row-parallel target's
  delta leaves each rank as a partial that is summed with the projection's
  own partial. k and v take B's columns by KV heads, as their weights do
  (JAX shards their B); one KV head keeps A and B whole: every rank
  computes the same k and v.
* Fused matrices are split at their boundaries before sharding:
  ``qkv`` becomes ``[q_r | k | v]`` and ``gateup`` ``[gate_r | up_r]``. A
  plain column slice of the fused matrix would give rank 0 all of q (or of
  gate), and the GeGLU epilogue, which splits its input at N/2, would pair
  the wrong columns.
* ``psum``, ``pmax`` and ``all_gather`` are the collectives: NCCL on the card; over
  gloo (the CPU tests, or processes that share one card) a CUDA tensor is
  staged through host memory inside the helper. That is a transport choice:
  every product stays on the card.
* Training (train/trainer under a mesh) differentiates through them as
  Megatron does: ``psum`` of a tensor that requires grad is a new tensor
  whose gradient passes through unchanged (the row-parallel output's
  operator), ``copy_to_model`` is the identity whose gradient is summed
  over the model axis (at a column-parallel input: each rank's heads or
  columns give part of it), ``all_gather`` / ``gather_vocab`` hand each
  rank the gradient of its own slice, and ``vocab_parallel_embed`` each
  rank the gradient of its own rows. Without autograd they are the
  inference paths, with the same bits. The data axis's collectives
  (``data_sum``, :class:`Fsdp`'s gathers) run over the gloo data group.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch
import torch.distributed as dist

from .config import GemmaConfig

MODEL = "model"
DATA = "data"
_COL_PROJ = {"q", "k", "v", "gate", "up", "fc1", "qkv", "gateup"}
_ROW_PROJ = {"o", "down", "fc2"}
_WEIGHT_NAMES = ("w8", "kernel", "w4")  # the weight of an int8 / dense / 4-bit dict
# the leaves of a row-parallel dict cut by input rows: the weight, and a
# 4-bit weight's block scales (..., K/group, N); int8 scales and biases stay
_ROW_KEYS = ("w8", "kernel", "w4", "s4")


@dataclasses.dataclass(frozen=True, kw_only=True)
class Mesh:
    """This rank's place in a ``data`` x ``model`` mesh: ``rank`` on the
    model axis, ``data_index`` on the data axis. ``group`` None is the
    default process group. A Mesh built by hand (no process group) is
    enough for ``shard_params`` and the per-rank kernels; the collectives
    need ``make_mesh``'s."""

    model: int = 1
    rank: int = 0
    data: int = 1
    group: Any = None  # the model group of this data index
    backend: str = "gloo"  # the model group's
    data_index: int = 0
    data_group: Any = None  # gloo, the data group of this model rank


def make_mesh(data: int = 1, model: Optional[int] = None, *, group=None) -> Mesh:
    """The mesh of an initialized process group (``init_process_group`` with
    its address, world size and rank first). ``model`` defaults to the world
    size over ``data``. With ``data > 1`` every rank of ``group`` (default:
    all) must call it, in the same order as any other ``new_group``: it
    makes the ``data`` model groups (the backend of ``group``) and the
    ``model`` data groups (gloo)."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh: call torch.distributed.init_process_group first")
    world = dist.get_world_size(group)
    model = world // data if model is None else model
    if data < 1 or data * model != world:
        raise ValueError(f"make_mesh: data {data} x model {model} != world size {world}")
    me, backend = dist.get_rank(group), dist.get_backend(group)
    if data == 1:
        return Mesh(model=model, rank=me, group=group, backend=backend)
    ranks = dist.get_process_group_ranks(group) if group is not None else list(range(world))
    model_group = data_group = None
    for i in range(data):
        g = dist.new_group([ranks[i * model + j] for j in range(model)], backend=backend)
        if me // model == i:
            model_group = g
    for j in range(model):
        g = dist.new_group([ranks[i * model + j] for i in range(data)], backend="gloo")
        if me % model == j:
            data_group = g
    return Mesh(model=model, rank=me % model, data=data, group=model_group, backend=backend,
                data_index=me // model, data_group=data_group)


def single_device_mesh() -> Mesh:
    """The 1 x 1 mesh (no process group: one card's engines take
    ``mesh=None``)."""
    return Mesh()


def split_axes(mesh: Optional[Mesh]) -> Tuple[Optional[Mesh], Optional[Mesh]]:
    """(the mesh an engine shards its weights over, the mesh it splits its
    rows over): the first None on one card and under pure DP (``model ==
    1``, whose ranks run one card's paths on their rows), the second None
    without a data axis."""
    if mesh is None:
        return None, None
    data = mesh if mesh.data > 1 else None
    return (None if data is not None and mesh.model == 1 else mesh), data


def data_rows(n: int, mesh: Optional[Mesh], what: str) -> slice:
    """This rank's rows of ``n`` split over the data axis (all of them
    without one); ``n % data`` raises ``ValueError``, as JAX's
    ``device_put`` of a batch on ``P("data")`` does."""
    d = 1 if mesh is None else mesh.data
    if n % d:
        raise ValueError(f"{what}: {n} rows do not split over a data axis of {d}")
    per = n // d
    i = 0 if mesh is None else mesh.data_index
    return slice(i * per, (i + 1) * per)


# ---------------------------------------------------------------------------
# Sharding rules
# ---------------------------------------------------------------------------
def _spec_for_leaf(names, ndim: int) -> Tuple:
    """Which dimension of a leaf shards on "model" (paligemma_tpu/core/
    mesh.py ``_spec_for_leaf``, with the patch embedding replicated)."""

    def axis(from_end: int) -> Tuple:
        spec = [None] * ndim
        spec[ndim - 1 - from_end] = MODEL
        return tuple(spec)

    rep = (None,) * ndim
    if "head_q" in names:
        return axis(0)  # w8 (K, V) and s (V,): the vocab
    if names[-1] == "embed":
        return axis(1)  # (V, H): the vocab
    if names[-1] in ("pos_embed", "final_norm", "grid") or "patch_embed" in names:
        return rep
    proj = next((n for n in names if n in _COL_PROJ | _ROW_PROJ), None)
    if proj is None:
        return rep  # norms, the projector
    if proj in _COL_PROJ:
        return axis(0)  # weights, scales and biases: the output columns
    return axis(1) if names[-1] in _ROW_KEYS or names[-1] == proj else rep


def _replicated(tree):
    if isinstance(tree, dict):
        return {k: _replicated(v) for k, v in tree.items()}
    return (None,) * tree.dim()


def _in_dim(leaf) -> int:
    """K of a (..., K, N) weight leaf (a 4-bit one packs two rows a byte)."""
    if isinstance(leaf, dict):
        if "w4" in leaf:
            return 2 * leaf["w4"].shape[-2]
        leaf = leaf[next(n for n in _WEIGHT_NAMES if n in leaf)]
    return leaf.shape[-2]


KV_LAYOUTS = ("one KV head (replicated)", "KV heads divisible by the model axis (split)",
              "a model axis divisible by the KV heads (one head a rank, shared)")


def kv_layout(kv_heads: int, model: int) -> str:
    """How k / v narrower than q lie over ``model`` ranks: "whole" (one KV
    head, replicated), "split" (``kv_heads / model`` heads a rank) or
    "shared" (rank r holds KV head ``r // (model / kv_heads)``, the one its
    query heads read). Any other layout raises ``NotImplementedError``."""
    if kv_heads == 1:
        return "whole"
    if kv_heads % model == 0:
        return "split"
    if model % kv_heads == 0:
        return "shared"
    raise NotImplementedError(
        f"tensor parallel over {model} ranks with {kv_heads} KV heads: the port takes "
        f"{', '.join(KV_LAYOUTS)}")


def kv_share(kv_heads: int, model: int) -> int:
    """Ranks that hold the same k / v slice: ``model / kv_heads`` in the
    shared layout, else 1 (a whole KV head counts as replicated)."""
    return model // kv_heads if kv_layout(kv_heads, model) == "shared" else 1


def _kv_whole(attn: Dict[str, Any], kv_heads: int) -> bool:
    """k and v narrower than q and one KV head: replicated, not sharded."""
    if "k" not in attn or "o" not in attn:
        return False
    return _width(attn["k"]) < _in_dim(attn["o"]) and kv_heads == 1


def param_specs(params: Dict[str, Any], *, kv_heads: int = 1) -> Dict[str, Any]:
    """The spec tuple of every leaf of a (dense or int8) params tree: the
    dimension ``shard_params`` slices over ``"model"`` (JAX's
    ``param_specs``, with the module docstring's two differences). A fused
    ``qkv`` / ``gateup`` names its columns, which ``shard_params`` splits
    at their boundaries first. ``kv_heads``: the LM's KV heads (k and v
    narrower than q are whole at 1, cut by KV heads otherwise)."""

    def walk(t, names):
        if not isinstance(t, dict):
            return _spec_for_leaf(names, t.dim())
        out = {k: walk(v, names + (k,)) for k, v in t.items()}
        if names and names[-1] == "attn" and _kv_whole(t, kv_heads):
            out.update({n: _replicated(t[n]) for n in ("k", "v")})
        return out

    return walk(params, ())


def _lora_q_width(layers: Dict[str, Any]) -> Optional[int]:
    """q's width from a LoRA tree's q or o adapter (None with neither)."""
    if "q" in layers:
        return layers["q"]["b"].shape[-1]
    if "o" in layers:
        return layers["o"]["a"].shape[-2]
    return None


def lora_specs(lora: Dict[str, Any], *, kv_heads: int = 1) -> Dict[str, Any]:
    """The spec tuples of a LoRA tree or a stacked bank (JAX's
    ``lora_specs``, and ``shard_lora``'s slices): q, gate and up shard B's
    (and b_cat's) output columns, o and down A's (and a_cat's) input rows;
    k and v B's columns too, by KV heads, unless they are narrower than q
    with one KV head (``kv_heads``), when they are whole (JAX shards their
    B); every other entry is replicated. An entry that is no dict (a bank's
    per-row ids) is left out."""
    layers = lora["layers"]
    nq = _lora_q_width(layers)
    out: Dict[str, Any] = {}
    for name, p in layers.items():
        if not isinstance(p, dict):
            continue
        if name in ("o", "down"):
            keys, dim = ("a", "a_cat"), -2
        elif name in ("k", "v"):
            if nq is None:
                raise ValueError("lora_specs: k / v adapters need q or o beside them to tell "
                                 "one KV head from one per query head")
            keys, dim = (("b", "b_cat") if p["b"].shape[-1] == nq or kv_heads > 1 else ()), -1
        else:
            keys, dim = ("b", "b_cat"), -1
        specs = {}
        for k, v in p.items():
            spec = [None] * v.dim()
            if k in keys:
                spec[v.dim() + dim] = MODEL
            specs[k] = tuple(spec)
        out[name] = specs
    return {"layers": out}


FSDP_MIN_BYTES = 1 << 16  # leaves below 64 KiB stay replicated under FSDP


def fsdp_param_specs(params: Dict[str, Any], mesh: Mesh, *,
                     kv_heads: int = 1) -> Dict[str, Any]:
    """ZeRO-3 specs (JAX's ``fsdp_param_specs``): ``param_specs`` with one
    more dimension of every leaf of at least 64 KiB on ``"data"``: the
    largest one that is not on ``"model"`` and whose size the data axis
    divides (ties: the earliest). Smaller leaves, and leaves with no such
    dimension, keep their spec. At ``data == 1``, ``param_specs``."""
    d = mesh.data
    base = param_specs(params, kv_heads=kv_heads)
    if d == 1:
        return base

    def walk(t, spec):
        if isinstance(t, dict):
            return {k: walk(t[k], spec[k]) for k in t}
        if t.dim() == 0 or t.numel() * t.element_size() < FSDP_MIN_BYTES:
            return spec
        cands = [i for i in range(t.dim())
                 if spec[i] is None and t.shape[i] % d == 0 and t.shape[i] > 1]
        if not cands:
            return spec
        ax = max(cands, key=lambda i: t.shape[i])
        return tuple(DATA if i == ax else a for i, a in enumerate(spec))

    return walk(params, base)


def batch_spec() -> Tuple:
    """A batch's rows over the data axis (JAX's ``batch_spec``)."""
    return (DATA,)


def kv_cache_specs() -> Dict[str, Tuple]:
    """A dense (L, B, S, n_kv, d) cache: its rows over the data axis; one KV
    head is replicated over the model axis (JAX's ``kv_cache_specs``)."""
    spec = (None, DATA, None, None, None)
    return {"k": spec, "v": spec}


def _slice(t: torch.Tensor, dim: int, lo: int, hi: int) -> torch.Tensor:
    """Rows / columns [lo, hi) of ``dim``, contiguous and not sharing the
    full tensor's storage (the whole tensor itself when nothing is cut)."""
    if lo == 0 and hi == t.shape[dim]:
        return t
    return t.narrow(dim, lo, hi - lo).clone(memory_format=torch.contiguous_format)


def _cols(leaf, lo: int, hi: int):
    """Output columns [lo, hi) of a column-parallel leaf: every tensor in it
    (weight, int8 or 4-bit scales, bias) has them last; a 4-bit codebook
    stays whole."""
    if isinstance(leaf, dict):
        return {k: v if k == "grid" else _cols(v, lo, hi) for k, v in leaf.items()}
    return _slice(leaf, leaf.dim() - 1, lo, hi)


def _cat_cols(*leaves):
    if isinstance(leaves[0], dict):
        return {k: leaves[0][k] if k == "grid" else _cat_cols(*(leaf[k] for leaf in leaves))
                for k in leaves[0]}
    return torch.cat(leaves, dim=-1)


def _width(leaf) -> int:
    w = leaf[next(n for n in _WEIGHT_NAMES if n in leaf)] if isinstance(leaf, dict) else leaf
    return w.shape[-1]


def _rows(leaf, m: int, r: int):
    """This rank's input rows of a row-parallel leaf: the weight's K rows;
    the int8 scales and the bias are replicated (added once, after the sum).
    A 4-bit weight keeps its packed rows and their block scales: the split
    must fall on a quantization block (``ValueError`` otherwise)."""
    if isinstance(leaf, dict):
        if "s4" in leaf and leaf["s4"].shape[-2] % m:
            raise ValueError(
                f"shard_params: a 4-bit weight of {_in_dim(leaf)} rows in "
                f"{leaf['s4'].shape[-2]} quantization blocks does not split over {m} ranks "
                "on a block boundary")
        return {k: _rows(v, m, r) if k in _ROW_KEYS else v for k, v in leaf.items()}
    k = leaf.shape[-2]
    if k % m:
        raise ValueError(f"shard_params: {k} rows do not split over {m} ranks")
    return _slice(leaf, leaf.dim() - 2, r * k // m, (r + 1) * k // m)


def _shard_cols(leaf, m: int, r: int):
    n = _width(leaf)
    if n % m:
        raise ValueError(f"shard_params: {n} columns do not split over {m} ranks")
    return _cols(leaf, r * n // m, (r + 1) * n // m)


def _kv_cols(leaf, m: int, r: int, kv_heads: int, nq: int):
    """This rank's k or v columns (of a weight leaf or a LoRA B): cut m
    ways when as wide as q or split by KV heads, KV head ``r // (m /
    kv_heads)`` when shared, whole for one KV head."""
    n = _width(leaf)
    layout = "split" if n == nq else kv_layout(kv_heads, m)
    if layout == "whole":
        return leaf
    if layout == "split":
        return _shard_cols(leaf, m, r)
    w = n // kv_heads
    h = r // (m // kv_heads)
    return _cols(leaf, h * w, (h + 1) * w)


def _shard_attn(attn: Dict[str, Any], m: int, r: int, kv_heads: int) -> Dict[str, Any]:
    """q sharded by heads, o by rows; k and v by KV heads (``_kv_cols``)."""
    o = attn["o"]  # (nq, K): its rows are q's width
    nq = _in_dim(o)
    out = {"o": _rows(o, m, r)}
    if "qkv" in attn:
        qkv = attn["qkv"]
        nkv = (_width(qkv) - nq) // 2
        q, k, v = (_cols(qkv, 0, nq), _cols(qkv, nq, nq + nkv), _cols(qkv, nq + nkv, nq + 2 * nkv))
    else:
        q, k, v = attn["q"], attn["k"], attn["v"]
    q = _shard_cols(q, m, r)
    k, v = _kv_cols(k, m, r, kv_heads, nq), _kv_cols(v, m, r, kv_heads, nq)
    out.update({"qkv": _cat_cols(q, k, v)} if "qkv" in attn else {"q": q, "k": k, "v": v})
    for name, leaf in attn.items():
        if name not in ("q", "k", "v", "qkv", "o"):
            raise NotImplementedError(f"shard_params: attention leaf {name!r}")
    return {k: out[k] for k in attn}  # the input's key order: a trainer pairs leaves by it


def _shard_mlp(mlp: Dict[str, Any], m: int, r: int) -> Dict[str, Any]:
    out = {}
    for name, leaf in mlp.items():
        if name == "gateup":  # [gate_r | up_r]
            inter = _width(leaf) // 2
            out[name] = _cat_cols(_shard_cols(_cols(leaf, 0, inter), m, r),
                                  _shard_cols(_cols(leaf, inter, 2 * inter), m, r))
        elif name in ("down", "fc2"):
            out[name] = _rows(leaf, m, r)
        else:  # gate, up, fc1
            out[name] = _shard_cols(leaf, m, r)
    return out


def shard_params(params: Dict[str, Any], mesh: Mesh, *, kv_heads: int = 1) -> Dict[str, Any]:
    """This rank's slices of a (dense or int8) params tree, or of one of its
    subtrees (e.g. ``params["lm"]``): column-parallel projections by output
    columns, row-parallel ones (o, down, fc2) by input rows, k and v by KV
    heads (``kv_heads``: the LM's, module docstring), the embedding and the
    int8 head by vocab, everything else replicated (the same tensors).
    Fused ``qkv`` / ``gateup`` are split at their boundaries first."""
    m, r = mesh.model, mesh.rank

    def walk(t, names):
        if not isinstance(t, dict):
            spec = _spec_for_leaf(names, t.dim())
            if MODEL not in spec:
                return t
            d = spec.index(MODEL)
            n = t.shape[d]
            if n % m:
                raise ValueError(f"shard_params: {'.'.join(names)} dim {d} ({n}) does not "
                                 f"split over {m} ranks")
            return _slice(t, d, r * n // m, (r + 1) * n // m)
        if names and names[-1] == "attn":
            return _shard_attn(t, m, r, kv_heads)
        if names and names[-1] == "mlp":
            return _shard_mlp(t, m, r)
        return {k: walk(v, names + (k,)) for k, v in t.items()}

    return walk(params, ())


def shard_lora(lora: Dict[str, Any], mesh: Mesh, *, kv_heads: int = 1) -> Dict[str, Any]:
    """This rank's slices of a LoRA tree (train/lora.init_lora: ``a`` (L,
    in, r), ``b`` (L, r, out)) or of a stacked bank (train/lora.
    stack_lora_bank: the adapter axis second, and ``a_cat`` (L, in, G),
    ``b_cat`` (L, G, out)), by ``lora_specs``; other entries (``alpha``,
    ``__ids__``) stay whole. Every rank then adds its own q / gate / up
    columns' delta, its k / v heads' delta (one KV head: the same on every
    rank), and for o and down a partial delta, summed across ranks beside
    the projection's partial (models/gemma ``_row_parallel``,
    kernels/decode_layer_tp)."""
    m, r = mesh.model, mesh.rank
    specs = lora_specs(lora, kv_heads=kv_heads)["layers"]
    layers = lora["layers"]
    nq = _lora_q_width(layers)

    def cut(name, t, spec):
        if MODEL not in spec:
            return t
        if name in ("k", "v"):
            return _kv_cols(t, m, r, kv_heads, nq)
        d = spec.index(MODEL)
        n = t.shape[d]
        if n % m:
            raise ValueError(f"shard_lora: {n} does not split over {m} ranks")
        return _slice(t, d, r * n // m, (r + 1) * n // m)

    out = {name: ({k: cut(name, v, specs[name][k]) for k, v in p.items()}
                  if isinstance(p, dict)
                  else p)  # the per-row ids of a bank (models/paligemma.lora_with_ids)
           for name, p in layers.items()}
    return {**lora, "layers": out}


def local_text_config(cfg: GemmaConfig, model: int) -> GemmaConfig:
    """The decoder config one rank computes with: its share of the query
    heads and of the MLP width, and its KV heads (``kv_layout``): one KV
    head whole, ``Hkv / model`` of them when the model axis divides them,
    the one its query heads read when it divides the model axis."""
    h, nkv, inter = cfg.num_attention_heads, cfg.num_key_value_heads, cfg.intermediate_size
    if h % model or inter % model or cfg.vocab_size % model:
        raise NotImplementedError(
            f"tensor parallel over {model} ranks needs heads ({h}), intermediate size "
            f"({inter}) and vocab ({cfg.vocab_size}) divisible by it")
    layout = kv_layout(nkv, model)
    return dataclasses.replace(cfg, num_attention_heads=h // model,
                               num_key_value_heads=nkv // model if layout == "split" else 1,
                               intermediate_size=inter // model)


def sum_shared(g: torch.Tensor, mesh: Mesh, kv_heads: int) -> torch.Tensor:
    """The gradient of a k / v slice that ``model / kv_heads`` ranks share
    (``kv_layout`` "shared"; columns last), summed over those ranks, in
    place: each rank's slice in a zero whole-width tensor at its KV head's
    columns, summed over the model group, and its slice read back. Returns
    ``g``."""
    w = g.shape[-1]
    h = mesh.rank // (mesh.model // kv_heads)
    whole = g.new_zeros(g.shape[:-1] + (w * kv_heads,))
    whole[..., h * w:(h + 1) * w] = g
    model_sum(whole, mesh)
    return g.copy_(whole[..., h * w:(h + 1) * w])


# ---------------------------------------------------------------------------
# Collectives
# ---------------------------------------------------------------------------
def _staged(mesh: Mesh, x: torch.Tensor) -> bool:
    return mesh.backend != "nccl" and x.is_cuda


def _reduce(x: torch.Tensor, group, staged: bool, op=dist.ReduceOp.SUM) -> torch.Tensor:
    """All-reduce ``x`` over ``group`` in place (through host memory when
    ``staged``); returns ``x``."""
    if staged:
        host = x.cpu()
        dist.all_reduce(host, op=op, group=group)
        return x.copy_(host)
    dist.all_reduce(x, op=op, group=group)
    return x


def _fresh(x: torch.Tensor) -> torch.Tensor:
    """A contiguous copy of ``x`` that a collective may write in place."""
    return x.clone(memory_format=torch.contiguous_format)


def _autograd(x: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and x.requires_grad


class _SumModel(torch.autograd.Function):
    """The sum over the model axis forward, the identity backward (the
    operator at a row-parallel output: every rank's output gradient is the
    whole one)."""

    @staticmethod
    def forward(ctx, x, mesh):
        return _reduce(_fresh(x), mesh.group, _staged(mesh, x))

    @staticmethod
    def backward(ctx, g):
        return g, None


class _CopyToModel(torch.autograd.Function):
    """The identity forward, the sum over the model axis backward."""

    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _reduce(_fresh(g), ctx.mesh.group, _staged(ctx.mesh, g)), None


def psum(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """Sum of ``x`` over the model axis, in place; returns ``x``. Under
    autograd (``x`` requires grad) a new tensor, whose gradient reaches
    ``x`` unchanged."""
    if _autograd(x):
        return _SumModel.apply(x, mesh)
    return _reduce(x, mesh.group, _staged(mesh, x))


def copy_to_model(x: torch.Tensor, mesh: Optional[Mesh]) -> torch.Tensor:
    """``x`` at the input of column-parallel projections (q, k, v, gate, up,
    the head, a tower's q, k, v and fc1). Under autograd its gradient is
    summed over the model axis, as each rank's heads or columns give a part
    of it; otherwise (and without a mesh) ``x`` itself."""
    if mesh is None or not _autograd(x):
        return x
    return _CopyToModel.apply(x, mesh)


def pmax(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """Elementwise max of ``x`` over the model axis, in place; returns ``x``
    (a W8A8 row-parallel projection's per-row amax over the whole K)."""
    if _staged(mesh, x):
        host = x.cpu()
        dist.all_reduce(host, op=dist.ReduceOp.MAX, group=mesh.group)
        return x.copy_(host)
    dist.all_reduce(x, op=dist.ReduceOp.MAX, group=mesh.group)
    return x


class _GatherModel(torch.autograd.Function):
    """``all_gather`` forward; backward, this rank's slice of the gradient
    (every rank computes the same function of the gathered whole)."""

    @staticmethod
    def forward(ctx, x, mesh):
        ctx.rank = mesh.rank
        return _gather_model(x, mesh)

    @staticmethod
    def backward(ctx, g):
        return g[ctx.rank], None


def all_gather(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """Every rank's ``x`` stacked in rank order: (model, *x.shape). Under
    autograd each rank's ``x`` gets the gradient of its own slice."""
    if _autograd(x):
        return _GatherModel.apply(x, mesh)
    return _gather_model(x, mesh)


def _gather_model(x: torch.Tensor, mesh: Mesh, host: bool = False) -> torch.Tensor:
    """``all_gather`` without autograd; ``host``: the result in host memory."""
    x = x.contiguous()
    if mesh.backend != "nccl":
        staged = x.cpu()
        parts = [torch.empty_like(staged) for _ in range(mesh.model)]
        dist.all_gather(parts, staged, group=mesh.group)
        out = torch.stack(parts)
        return out if host else out.to(x.device)
    out = torch.empty((mesh.model,) + tuple(x.shape), dtype=x.dtype, device=x.device)
    dist.all_gather_into_tensor(out, x, group=mesh.group)
    return out.cpu() if host else out


def gather_data(x: torch.Tensor, mesh: Optional[Mesh], dim: int = 0) -> torch.Tensor:
    """Every data shard's ``x`` concatenated along ``dim`` in data order
    (the shards' rows in batch or slot order), on ``x``'s device: the one
    collective of the data axis, for values the host reads back (over the
    gloo data group, through host memory). Without a data axis, ``x``."""
    if mesh is None or mesh.data == 1:
        return x
    host = x.detach().cpu().contiguous()
    parts = [torch.empty_like(host) for _ in range(mesh.data)]
    dist.all_gather(parts, host, group=mesh.data_group)
    return torch.cat(parts, dim=dim).to(x.device)


def gather_vocab(logits: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """(..., V/m) logits of this rank's vocab shard -> (..., V), in fp32."""
    parts = all_gather(logits.float(), mesh)  # (m, ..., V/m)
    return torch.cat(parts.unbind(0), dim=-1)


def vocab_parallel_embed(table: torch.Tensor, ids: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """Rows of a vocab-sharded (V/m, H) embedding for global ``ids``: each
    rank gathers the ids in its shard (zeros elsewhere) and the ranks' rows
    are summed, which is exact (one nonzero term per id). Under autograd
    each rank's table gets the gradient of the rows it holds."""
    vl = table.shape[0]
    local = ids.long() - mesh.rank * vl
    mine = (local >= 0) & (local < vl)
    rows = table[local.clamp(0, vl - 1)].float() * mine[..., None]
    return psum(rows, mesh).to(table.dtype)


# ---------------------------------------------------------------------------
# The data axis of training: sums and FSDP gathers over the gloo data group
# ---------------------------------------------------------------------------
def data_sum(x: torch.Tensor, mesh: Optional[Mesh]) -> torch.Tensor:
    """Sum of ``x`` over the data axis, in place (``x`` without one);
    returns ``x``. No autograd."""
    if mesh is None or mesh.data == 1:
        return x
    return _reduce(x, mesh.data_group, x.is_cuda)


def model_sum(x: torch.Tensor, mesh: Optional[Mesh]) -> torch.Tensor:
    """Sum of ``x`` over the model axis, in place (``x`` without one);
    returns ``x``. No autograd."""
    if mesh is None or mesh.model == 1:
        return x
    return _reduce(x, mesh.group, _staged(mesh, x))


def _gather_data(x: torch.Tensor, mesh: Mesh, dim: int, host: bool = False) -> torch.Tensor:
    staged = x.detach().cpu().contiguous()
    parts = [torch.empty_like(staged) for _ in range(mesh.data)]
    dist.all_gather(parts, staged, group=mesh.data_group)
    out = torch.cat(parts, dim=dim)
    return out if host else out.to(x.device)


class _GatherData(torch.autograd.Function):
    """An FSDP leaf's data shards joined along ``dim`` forward; backward,
    the gradient summed over the data axis and this rank's shard kept (the
    reduce-scatter, as a sum and a slice: gloo has no reduce-scatter)."""

    @staticmethod
    def forward(ctx, x, mesh, dim):
        ctx.mesh, ctx.dim, ctx.n = mesh, dim, x.shape[dim]
        return _gather_data(x, mesh, dim)

    @staticmethod
    def backward(ctx, g):
        total = data_sum(_fresh(g), ctx.mesh)
        mine = total.narrow(ctx.dim, ctx.mesh.data_index * ctx.n, ctx.n)
        return mine.contiguous(), None, None


def shard_data(tree: Dict[str, Any], specs: Dict[str, Any], mesh: Mesh):
    """(this rank's data shard of every leaf whose spec names ``"data"``,
    the tree of those dimensions, None for a whole leaf). ``tree`` holds
    the rank's model slices (``shard_params``) and ``specs`` the whole
    tree's ``fsdp_param_specs``."""

    def walk(t, spec):
        if isinstance(t, dict):
            pairs = {k: walk(t[k], spec[k]) for k in t}
            return {k: v[0] for k, v in pairs.items()}, {k: v[1] for k, v in pairs.items()}
        if DATA not in spec:
            return t, None
        dim = spec.index(DATA)
        n = t.shape[dim] // mesh.data
        return _slice(t, dim, mesh.data_index * n, (mesh.data_index + 1) * n), dim

    return walk(tree, specs)


def unshard_data(tree, dims, mesh: Mesh, *, host: bool = False):
    """``shard_data``'s inverse on a tree laid out as ``dims``: every shard
    joined over the data axis (collective over the data group; no
    autograd). ``host``: the joined leaves in host memory."""
    if isinstance(tree, dict):
        return {k: unshard_data(tree[k], dims[k], mesh, host=host) for k in tree}
    return tree if dims is None else _gather_data(tree, mesh, dims, host)


class LocalRows(dict):
    """A batch whose rows are already this rank's shard of the data axis
    (core/multihost.global_batch_from_local): the trainer takes it whole
    instead of cutting its rows by ``data_rows``."""


class Fsdp:
    """The gathers of a tree whose leaves are data shards (``shard_data``):
    a leaf is joined over the data axis where it is used, under autograd
    with its gradient summed over the data axis and cut back to the shard.
    Leaves are known by identity, so the same shard tensors must be passed
    in (the trainer updates them in place)."""

    def __init__(self, mesh: Mesh, tree: Dict[str, Any], dims: Dict[str, Any]):
        self.mesh = mesh
        self._dims: Dict[int, Tuple[torch.Tensor, int]] = {}

        def walk(t, d):
            if isinstance(t, dict):
                for k in t:
                    walk(t[k], d[k])
            elif d is not None:
                self._dims[id(t)] = (t, d)

        walk(tree, dims)

    def _dim(self, t) -> Optional[int]:
        hit = self._dims.get(id(t))
        return hit[1] if hit is not None and hit[0] is t else None

    def _join(self, t: torch.Tensor, dim: int) -> torch.Tensor:
        if torch.is_grad_enabled() and t.requires_grad:
            return _GatherData.apply(t, self.mesh, dim)
        return _gather_data(t, self.mesh, dim)

    def full(self, tree):
        """``tree`` with every shard joined (a leaf, or a dict of them)."""
        if isinstance(tree, dict):
            return {k: self.full(v) for k, v in tree.items()}
        dim = self._dim(tree)
        return tree if dim is None else self._join(tree, dim)

    def layer(self, tree, i: int):
        """Layer ``i`` of a stacked (L, ...) tree, every shard joined: a
        shard over another dimension gathers only layer i's slice."""
        if isinstance(tree, dict):
            return {k: self.layer(v, i) for k, v in tree.items()}
        dim = self._dim(tree)
        if dim is None:
            return tree[i]
        if dim == 0:  # the layers themselves are sharded
            return self._join(tree, 0)[i]
        return self._join(tree[i], dim - 1)


# ---------------------------------------------------------------------------
# The inverses: one card's layout from the ranks' slices
# ---------------------------------------------------------------------------
def _joined(t: torch.Tensor, mesh: Mesh, dim: int, host: bool) -> torch.Tensor:
    return torch.cat(_gather_model(t.detach(), mesh, host).unbind(0), dim=dim)


def _join_cols(leaf, mesh: Mesh, host: bool):
    if isinstance(leaf, dict):
        return {k: v if k == "grid" else _join_cols(v, mesh, host) for k, v in leaf.items()}
    return _joined(leaf, mesh, leaf.dim() - 1, host)


def _join_rows(leaf, mesh: Mesh, host: bool):
    if isinstance(leaf, dict):
        return {k: _join_rows(v, mesh, host) if k in _ROW_KEYS else v for k, v in leaf.items()}
    return _joined(leaf, mesh, leaf.dim() - 2, host)


def _parts(leaf, mesh: Mesh, host: bool):
    """Every rank's copy of a leaf (or dict), in rank order."""
    if isinstance(leaf, dict):
        per = {k: _parts(v, mesh, host) for k, v in leaf.items()}
        return [{k: per[k][r] for k in leaf} for r in range(mesh.model)]
    return list(_gather_model(leaf.detach(), mesh, host).unbind(0))


def _kv_layout_local(nkv_r: int, nq_r: int, kv_heads: Optional[int], m: int) -> str:
    """``kv_layout`` of a rank's k / v columns (nkv_r wide beside q's
    nq_r): the LM's for ``kv_heads``; without, "split" when as wide as q
    and "whole" when narrower (the slices alone cannot tell a shared KV
    head from a head a rank when a rank holds one query head)."""
    if kv_heads is not None:
        return kv_layout(kv_heads, m)
    return "split" if nkv_r == nq_r else "whole"


def _join_kv(parts, layout: str, m: int, kv_heads: int):
    """The whole k / v columns from every rank's (``parts``, rank order)."""
    if layout == "whole":
        return parts[0]
    if layout == "shared":
        parts = parts[::m // kv_heads]  # the first rank of each KV head
    return _cat_cols(*parts)


def unshard_params(local: Dict[str, Any], mesh: Mesh, *, kv_heads: Optional[int] = None,
                   host: bool = False) -> Dict[str, Any]:
    """The whole tree of which ``local`` holds this rank's ``shard_params``
    slices, on every rank (collective over the model group). ``kv_heads``:
    the LM's KV heads when ``local`` is the LM tree (or its subtree);
    without, k and v are cut like q when as wide as it and whole when
    narrower (the vision tower; an LM of one KV head). ``host``: the
    joined leaves in host memory (the whole leaves never held on the
    device together). The leaves may be data
    shards too (``shard_data``): the data dimension is never a model one,
    so this gives the data shards of the whole tree."""
    m = mesh.model
    if m == 1:
        return local

    def attn(t):
        nq_r = _in_dim(t["o"])  # o's rows are this rank's q columns
        out = {"o": _join_rows(t["o"], mesh, host)}
        if "qkv" in t:
            parts = _parts(t["qkv"], mesh, host)
            w = _width(t["qkv"])
            nkv = (w - nq_r) // 2
            layout = _kv_layout_local(nkv, nq_r, kv_heads, m)
            q = _cat_cols(*(_cols(p, 0, nq_r) for p in parts))
            kv = [_join_kv([_cols(p, lo, hi) for p in parts], layout, m, kv_heads)
                  for lo, hi in ((nq_r, nq_r + nkv), (nq_r + nkv, w))]
            out["qkv"] = _cat_cols(q, *kv)
        else:
            out["q"] = _join_cols(t["q"], mesh, host)
            layout = _kv_layout_local(_width(t["k"]), nq_r, kv_heads, m)
            for n in ("k", "v"):
                out[n] = t[n] if layout == "whole" else _join_kv(
                    _parts(t[n], mesh, host), layout, m, kv_heads)
        return {k: out[k] for k in t}

    def mlp(t):
        out = {}
        for name, leaf in t.items():
            if name == "gateup":
                parts, half = _parts(leaf, mesh, host), _width(leaf) // 2
                out[name] = _cat_cols(*(_cols(p, 0, half) for p in parts),
                                      *(_cols(p, half, 2 * half) for p in parts))
            elif name in ("down", "fc2"):
                out[name] = _join_rows(leaf, mesh, host)
            else:
                out[name] = _join_cols(leaf, mesh, host)
        return out

    def walk(t, names):
        if not isinstance(t, dict):
            spec = _spec_for_leaf(names, t.dim())
            return t if MODEL not in spec else _joined(t, mesh, spec.index(MODEL), host)
        if names and names[-1] == "attn":
            return attn(t)
        if names and names[-1] == "mlp":
            return mlp(t)
        return {k: walk(v, names + (k,)) for k, v in t.items()}

    return walk(local, ())


def unshard_lora(local: Dict[str, Any], specs: Dict[str, Any], mesh: Mesh, *,
                 kv_heads: int = 1, host: bool = False) -> Dict[str, Any]:
    """The whole LoRA tree of ``shard_lora``'s slices (taken with the same
    ``kv_heads``), on every rank; ``specs``: ``lora_specs`` of the whole
    tree (collective over the model group). ``host``: the joined leaves in
    host memory."""
    m = mesh.model
    if m == 1:
        return local
    layers = {}
    for name, p in local["layers"].items():
        spec = specs["layers"][name]
        out = {}
        for k, v in p.items():
            if MODEL not in spec[k]:
                out[k] = v
            elif name in ("k", "v") and kv_layout(kv_heads, m) == "shared":
                out[k] = _join_kv(_parts(v, mesh, host), "shared", m, kv_heads)
            else:
                out[k] = _joined(v, mesh, spec[k].index(MODEL), host)
        layers[name] = out
    return {**local, "layers": layers}
