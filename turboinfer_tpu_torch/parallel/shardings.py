"""Parameter and cache placement on a (data, tp) mesh (counterpart of
turboinfer_tpu/parallel/shardings.py).

The spec sets are the JAX package's, slot for slot: a spec is a tuple
with one entry per array axis, the mesh axis that axis splits over or
None (JAX's PartitionSpec). JAX places arrays and GSPMD keeps
single-device semantics whatever the placement; here each rank holds
its own slice of every split slot and runs the family forward on its
own heads, columns and experts (ShardedModel), and the forwards call
the few collectives of parallel/comm.py. So the port's placement of the
slots the spec sets do not name is its own:
  - q/k/v biases split with their columns, b_o (GPT-OSS) replicates and
    is added once after the all-reduce;
  - a q/k norm over the whole projection (OLMoE) splits with q/k, a
    per-head one replicates; GPT-OSS's sinks [L, Hq] split by head;
  - a LoRA adapter of a column slot splits B's columns, of a row slot
    (wo, w_down) A's rows;
  - GPT-OSS's expert stacks replicate (JAX gives GPT-OSS the dense
    specs), and the GPT-2 and NeoX families replicate whole under a mesh
    (ROADMAP §3 Decisions): their forwards run on every rank unchanged.
A QTensor splits its data, scales and zero points with the logical
weight's spec. A split must keep whole quantization groups (the scales'
G axis divides) and, across columns, N % 8 == 0 a rank (the qmm
kernels' loads); a split axis that does not divide raises ValueError
naming the slot, as JAX's placement does. The port's scales are always
[(L,) (E,) G, N], never pre-tiled, so JAX's fit_spec has no work here
and is left out.
Caches are never sliced from a whole one: each rank makes its own
through the family's init_cache / init_paged_cache on local_config (its
kv heads; an MLA latent whole) for data_rows' rows, which are the shapes
of the device shards of JAX's cache specs.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from turboinfer_tpu_torch.config import ModelConfig
from turboinfer_tpu_torch.core.qtensor import QEmbed, QTensor
from turboinfer_tpu_torch.parallel import comm
from turboinfer_tpu_torch.parallel.mesh import DATA_AXIS, TP_AXIS, Mesh

Spec = Tuple[Optional[str], ...]


def P(*axes: Optional[str]) -> Spec:
    return tuple(axes)


def param_specs(tp: str = TP_AXIS) -> Dict[str, Any]:
    """The dense specs (llama family, GPT-OSS): q/k/v, gate/up and the
    head split by columns, wo and w_down by rows."""
    return {
        "embed": P(None, None),
        "layers": {
            "attn_norm": P(None, None),
            "ffn_norm": P(None, None),
            "wq": P(None, None, tp),
            "wk": P(None, None, tp),
            "wv": P(None, None, tp),
            "wo": P(None, tp, None),
            "w_gate": P(None, None, tp),
            "w_up": P(None, None, tp),
            "w_down": P(None, tp, None),
        },
        "final_norm": P(None),
        "lm_head": P(None, tp),
    }


def moe_param_specs(tp: str = TP_AXIS) -> Dict[str, Any]:
    """The MoE specs: the expert axis over tp (expert parallelism), the
    router replicated, the shared expert by columns and rows."""
    return {
        "embed": P(None, None),
        "layers": {
            "attn_norm": P(None, None),
            "ffn_norm": P(None, None),
            "wq": P(None, None, tp),
            "wk": P(None, None, tp),
            "wv": P(None, None, tp),
            "wo": P(None, tp, None),
            "router": P(None, None, None),
            "we_gate": P(None, tp, None, None),
            "we_up": P(None, tp, None, None),
            "we_down": P(None, tp, None, None),
            "ws_gate": P(None, None, tp),
            "ws_up": P(None, None, tp),
            "ws_down": P(None, tp, None),
            "shared_gate": P(None, None, None),
        },
        "final_norm": P(None),
        "lm_head": P(None, tp),
    }


def deepseek_param_specs(tp: str = TP_AXIS) -> Dict[str, Any]:
    """The DeepSeek specs: MLA heads over tp (wq/wq_b and wkv_b columns,
    wo rows), the latent projections replicated, experts as in
    moe_param_specs, the dense group's FFN by columns and rows."""
    attn = {
        "attn_norm": P(None, None),
        "ffn_norm": P(None, None),
        "kv_a_norm": P(None, None),
        "wkv_a": P(None, None, None),
        "wkv_b": P(None, None, tp),
        "wo": P(None, tp, None),
        "wq": P(None, None, tp),
        "wq_a": P(None, None, None),
        "q_a_norm": P(None, None),
        "wq_b": P(None, None, tp),
    }
    layers = dict(attn)
    layers.update({
        "router": P(None, None, None),
        "router_bias": P(None, None),
        "we_gate": P(None, tp, None, None),
        "we_up": P(None, tp, None, None),
        "we_down": P(None, tp, None, None),
        "ws_gate": P(None, None, tp),
        "ws_up": P(None, None, tp),
        "ws_down": P(None, tp, None),
    })
    dense = dict(attn)
    dense.update({
        "w_gate": P(None, None, tp),
        "w_up": P(None, None, tp),
        "w_down": P(None, tp, None),
    })
    return {
        "embed": P(None, None),
        "layers": layers,
        "dense_layers": dense,
        "final_norm": P(None),
        "lm_head": P(None, tp),
    }


# -- families --------------------------------------------------------------

# families that run whole on every rank under a mesh (ROADMAP §3)
REPLICATED = ("gpt2", "neox")


def family(config: ModelConfig) -> str:
    from turboinfer_tpu_torch.models import registry
    return registry.get_model(config.architecture).__name__.rsplit(".", 1)[-1]


def specs_for(config: ModelConfig) -> Dict[str, Any]:
    """The spec set of config's family, as JAX's cli picks it: experts
    over tp for the MoE family, MLA heads and experts for DeepSeek, the
    dense specs otherwise (GPT-OSS included)."""
    return {"moe": moe_param_specs,
            "deepseek": deepseek_param_specs}.get(family(config),
                                                  param_specs)()


# -- slicing ---------------------------------------------------------------

def _axis_size(mesh: Mesh, name: str) -> Tuple[int, int]:
    if name == TP_AXIS:
        return mesh.tp, mesh.tp_rank
    if name == DATA_AXIS:
        return mesh.data, mesh.data_rank
    raise ValueError(f"unknown mesh axis {name!r}")


def _take(t: torch.Tensor, spec: Spec, mesh: Mesh, name: str
          ) -> torch.Tensor:
    """This rank's block of t under spec: t itself when no axis splits,
    else a copy (so the whole array can be freed)."""
    if len(spec) > t.dim():
        raise ValueError(f"{name}: spec {spec} has more axes than its "
                         f"shape {tuple(t.shape)}")
    out = t
    for ax, axis_name in enumerate(spec):
        if axis_name is None:
            continue
        n, i = _axis_size(mesh, axis_name)
        if n == 1:
            continue
        if t.shape[ax] % n:
            raise ValueError(
                f"{name}: axis {ax} of shape {tuple(t.shape)} does not "
                f"divide over the {n} ranks of mesh axis {axis_name!r}")
        s = t.shape[ax] // n
        out = out.narrow(ax, i * s, s)
    if out is t:
        return t
    return torch.empty_like(out, memory_format=torch.contiguous_format
                            ).copy_(out)


def _take_qtensor(q: QTensor, spec: Spec, mesh: Mesh, name: str) -> QTensor:
    nd = q.data.dim()
    spec = tuple(spec) + (None,) * (nd - len(spec))
    K, N = q.shape
    k_ax, n_ax = spec[nd - 2], spec[nd - 1]
    if k_ax is not None:
        n, _ = _axis_size(mesh, k_ax)
        G = q.scales.shape[-2]
        if n > 1 and G % n:
            raise ValueError(
                f"{name}: a row split over {n} ranks would cut a "
                f"quantization group ({G} groups of {q.group_size})")
        K //= n
    if n_ax is not None:
        n, _ = _axis_size(mesh, n_ax)
        if n > 1 and (N % n or (N // n) % 8):
            raise ValueError(
                f"{name}: {N} columns over {n} ranks leave "
                f"{N / n:g} a rank; the qmm kernels need a multiple of 8")
        N //= n
    return QTensor(data=_take(q.data, spec, mesh, name + ".data"),
                   scales=_take(q.scales, spec, mesh, name + ".scales"),
                   zero_points=None if q.zero_points is None else _take(
                       q.zero_points, spec, mesh, name + ".zero_points"),
                   bits=q.bits, group_size=q.group_size, shape=(K, N))


def _place(leaf, spec: Spec, mesh: Mesh, name: str):
    if leaf is None or not any(a is not None for a in spec):
        return leaf
    if isinstance(leaf, QTensor):
        return _take_qtensor(leaf, spec, mesh, name)
    if isinstance(leaf, QEmbed):
        raise ValueError(f"{name}: a quantized embedding table cannot be "
                         "split; it replicates")
    return _take(leaf, spec, mesh, name)


def _width(w) -> int:
    return w.shape[-1] if not isinstance(w, QTensor) else w.shape[1]


def _extra_specs(layers: Dict[str, Any], specs: Dict[str, Any]
                 ) -> Dict[str, Spec]:
    """The port's placement of the slots a spec set does not name (module
    docstring)."""
    out: Dict[str, Spec] = {}
    col = specs.get("wq", P())[-1:] == (TP_AXIS,)
    for name, w in layers.items():
        if name in specs or w is None:
            continue
        if name in ("b_q", "b_k", "b_v") and col:
            out[name] = P(None, TP_AXIS)
        elif name in ("q_norm", "k_norm") and col:
            src = layers.get("wq" if name == "q_norm" else "wk")
            if src is not None and w.shape[-1] == _width(src):
                out[name] = P(None, TP_AXIS)
        elif name == "sinks" and col:
            out[name] = P(None, TP_AXIS)
        elif name.startswith("lora_") and name[-2:] in ("_a", "_b"):
            base = specs.get(name[5:-2])
            if base is None:
                continue
            if name.endswith("_b") and base[-1] == TP_AXIS:
                out[name] = P(None, None, TP_AXIS)
            elif name.endswith("_a") and base[-2] == TP_AXIS:
                out[name] = P(None, TP_AXIS, None)
    return out


def shard_params(params: Dict[str, Any], mesh: Mesh,
                 specs: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
    """This rank's slice of every split slot of an unfused parameter tree
    (the slots no spec names replicate, or follow the module docstring's
    rules in a layer group). Fusion (kernels/dispatch.prepare_params)
    comes after, on the rank's own slices."""
    specs = specs or param_specs()
    for group in ("layers", "dense_layers"):
        lw = params.get(group) or {}
        for fused in ("wqkv", "w_gateup", "we_gateup"):
            if fused in lw:
                raise ValueError(f"{group}/{fused}: shard an unfused tree; "
                                 "fused columns straddle the ranks")

    def walk(p, s, path):
        if isinstance(p, dict):
            s = s if isinstance(s, dict) else {}
            if path and path[-1] in ("layers", "dense_layers"):
                s = {**s, **_extra_specs(p, s)}
            return {k: walk(v, s.get(k), path + (k,)) for k, v in p.items()}
        return _place(p, s if isinstance(s, tuple) else P(), mesh,
                      "/".join(path))

    return walk(params, specs, ())


def data_rows(n: int, mesh: Optional[Mesh]) -> Tuple[int, int]:
    """(first, count) of the n batch rows this data rank runs: its block
    where n divides the data axis, else all n (replicated, as JAX's
    shard_cache places a batch that does not divide). Caches are made
    for these rows only (init_cache on the rank's config and count)."""
    if mesh is None or mesh.data == 1 or n % mesh.data:
        return 0, n
    k = n // mesh.data
    return mesh.data_rank * k, k


def replicate_for_host(rows, mesh: Optional[Mesh]):
    """The data-split rows of every data rank, in order, on every rank: a
    list of host rows (one all-gather on the data axis)."""
    if mesh is None or mesh.data == 1:
        return list(rows)
    return [r for part in comm.gather_rows_for_host(list(rows), mesh)
            for r in part]


# -- the rank-local model --------------------------------------------------

def local_config(config: ModelConfig, tp: int) -> ModelConfig:
    """The config a rank's forward runs on: its share of the query and kv
    heads (the head dim pinned). Vocabulary, widths and the expert count
    stay global (the head gathers the vocab; routing is replicated and
    each rank finds its experts from its weights)."""
    fam = family(config)
    if tp == 1 or fam in REPLICATED:
        return config
    Hq, Hkv = config.num_heads, config.kv_heads
    if fam == "deepseek":
        if Hq % tp:
            raise ValueError(f"{Hq} heads do not divide over tp={tp}")
        return config.replace(num_heads=Hq // tp)
    if Hq % tp or Hkv % tp:
        raise ValueError(f"{Hq} query and {Hkv} kv heads do not divide "
                         f"over tp={tp}: each rank needs whole heads")
    return config.replace(num_heads=Hq // tp, num_kv_heads=Hkv // tp,
                          head_dim=config.head_dim_)


def rank_config(config: ModelConfig, mesh: Optional[Mesh]) -> ModelConfig:
    """local_config on a mesh's tp axis; config itself off a mesh."""
    return config if mesh is None else local_config(config, mesh.tp)


_PARAMS_FIRST = ("forward", "forward_no_cache", "forward_paged_decode",
                 "forward_paged_verify")


class ShardedModel:
    """A family module whose forwards run on this rank's slice: each call
    gets the rank-local config (local_config) and runs with the mesh
    active for parallel/comm's collectives; init_cache makes the rank's
    heads. Every other attribute is the module's."""

    def __init__(self, module, mesh: Mesh):
        self.module = module
        self.mesh = mesh
        self._local: Dict[ModelConfig, ModelConfig] = {}

    def local(self, config: ModelConfig) -> ModelConfig:
        if config not in self._local:
            self._local[config] = local_config(config, self.mesh.tp)
        return self._local[config]

    def __getattr__(self, name):
        fn = getattr(self.module, name)
        if name in _PARAMS_FIRST:
            def call(params, config, *args, **kw):
                with comm.active(self.mesh):
                    return fn(params, self.local(config), *args, **kw)
            return call
        if name == "init_cache":
            def init(config, *args, **kw):
                return fn(self.local(config), *args, **kw)
            return init
        return fn


def rank_model(module, config: ModelConfig, mesh: Optional[Mesh]):
    """The module itself off a mesh, on a tp axis of 1 or for a
    replicated family; else its ShardedModel."""
    if mesh is None or mesh.tp == 1 or family(config) in REPLICATED:
        return module
    return ShardedModel(module, mesh)


def rank_params(params: Dict[str, Any], config: ModelConfig,
                mesh: Optional[Mesh]) -> Dict[str, Any]:
    """The rank's slice of an unfused tree under its family's spec set
    (specs_for; the tree itself where the model replicates). The set is
    not a choice: each family's rank-local forward follows its own."""
    if mesh is None or mesh.tp == 1 or family(config) in REPLICATED:
        return params
    return shard_params(params, mesh, specs_for(config))
