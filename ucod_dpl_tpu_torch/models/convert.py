"""Carry weights between the JAX package and the port.

The JAX package keeps its parameters as pytrees in JAX layouts (patch and
discriminator kernels HWIO, linears ``(in, out)``, decoder 1x1 convs ``(in,
out)``, LoRA ``a`` (d_in, r) and ``b`` (r, d_out)); the port keeps the same
names in PyTorch layouts (kernels OIHW, linears ``(out, in)``, LoRA ``a``
(r, d_in) and ``b`` (d_out, r)).  These functions map numpy trees of the
former to tensor trees of the latter and back, transposing explicitly and
nothing else, so a round trip is exact.  Nothing here imports JAX: JAX arrays arrive and leave
as numpy arrays.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Mapping

import numpy as np
import torch

from ucod_dpl_tpu_torch.models.dba import RevDecoderParams

_LINEARS = ("q", "k", "v", "out", "fc1", "fc2")


def tree_map(fn: Callable[[torch.Tensor], torch.Tensor], tree: Any) -> Any:
    """Apply ``fn`` to every tensor of a nested dict/list/tuple of params."""
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, RevDecoderParams):
        return RevDecoderParams(*(tree_map(fn, x) for x in tree))
    if isinstance(tree, Mapping):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v) for v in tree)
    raise TypeError(f"unexpected leaf {type(tree)!r} in a params tree")


def tree_leaves(tree: Any) -> list:
    """The tensors of a nested dict/list/tuple of params, in ``tree_map``'s
    order."""
    leaves: list = []
    tree_map(lambda t: leaves.append(t) or t, tree)
    return leaves


def params_to(tree: Any, device) -> Any:
    """Move every tensor of a params tree to ``device``."""
    return tree_map(lambda t: t.to(device), tree)


def snapshot(tree: Any) -> Any:
    """Detached copies of a params tree: what a Runner reads (checkpoints,
    validation) must not alias tensors that the next step changes in place."""
    return tree_map(lambda t: t.detach().clone(), tree)


def _t(x) -> torch.Tensor:
    """A C-contiguous float32 copy (a transposed view would otherwise keep
    its strides, and a product of a strided weight may round otherwise)."""
    return torch.from_numpy(np.array(x, dtype=np.float32, order="C", copy=True))


def _n(x: torch.Tensor) -> np.ndarray:
    return np.ascontiguousarray(x.detach().to("cpu", torch.float32).numpy())


def dino_from_jax(tree: Mapping[str, Any]) -> Dict[str, Any]:
    """JAX ``init_dino``/``convert_hf_state_dict`` params (numpy values) ->
    port params on the CPU."""
    out: Dict[str, Any] = {
        "patch_embed": {
            "kernel": _t(np.transpose(np.asarray(tree["patch_embed"]["kernel"]), (3, 2, 0, 1))),
            "bias": _t(tree["patch_embed"]["bias"]),
        },
        "cls_token": _t(tree["cls_token"]),
        "pos_embed": _t(tree["pos_embed"]),
        "final_norm": {k: _t(v) for k, v in tree["final_norm"].items()},
        "layers": [],
    }
    for layer in tree["layers"]:
        new = {}
        for name, p in layer.items():
            if name in _LINEARS:
                new[name] = {"w": _t(np.asarray(p["w"]).T), "b": _t(p["b"])}
            elif isinstance(p, Mapping):
                new[name] = {k: _t(v) for k, v in p.items()}
            else:
                new[name] = _t(p)
        out["layers"].append(new)
    return out


def dino_to_jax(params: Mapping[str, Any]) -> Dict[str, Any]:
    """Port params -> a numpy tree in the JAX layout (inverse of
    :func:`dino_from_jax`)."""
    out: Dict[str, Any] = {
        "patch_embed": {
            "kernel": np.ascontiguousarray(np.transpose(_n(params["patch_embed"]["kernel"]), (2, 3, 1, 0))),
            "bias": _n(params["patch_embed"]["bias"]),
        },
        "cls_token": _n(params["cls_token"]),
        "pos_embed": _n(params["pos_embed"]),
        "final_norm": {k: _n(v) for k, v in params["final_norm"].items()},
        "layers": [],
    }
    for layer in params["layers"]:
        new = {}
        for name, p in layer.items():
            if name in _LINEARS:
                new[name] = {"w": np.ascontiguousarray(_n(p["w"]).T), "b": _n(p["b"])}
            elif isinstance(p, Mapping):
                new[name] = {k: _n(v) for k, v in p.items()}
            else:
                new[name] = _n(p)
        out["layers"].append(new)
    return out


def quant_from_jax(qtree: Mapping[str, Any]) -> Dict[str, Any]:
    """JAX ``quantize_dino_linears`` output (numpy values) -> port int8
    linears on the CPU: ``w_q`` (in, out) int8 -> (out, in), the scales and
    biases as they are."""
    return {"layers": [{name: {"w_q": torch.from_numpy(np.ascontiguousarray(np.asarray(p["w_q"], np.int8).T)),
                               "w_s": _t(p["w_s"]), "b": _t(p["b"])}
                        for name, p in layer.items()}
                       for layer in qtree["layers"]]}


def quant_to_jax(q: Mapping[str, Any]) -> Dict[str, Any]:
    """Port int8 linears -> a numpy tree in the JAX layout (inverse of
    :func:`quant_from_jax`)."""
    return {"layers": [{name: {"w_q": np.ascontiguousarray(p["w_q"].cpu().numpy().T),
                               "w_s": _n(p["w_s"]), "b": _n(p["b"])}
                        for name, p in layer.items()}
                       for layer in q["layers"]]}


def decoder_from_jax(p: Any) -> RevDecoderParams:
    """A JAX ``RevDecoderParams`` (or a dict with its field names; numpy
    values) -> port decoder params on the CPU."""
    get = p.__getitem__ if isinstance(p, Mapping) else lambda k: getattr(p, k)
    return RevDecoderParams(
        decoupling_w=_t(np.asarray(get("decoupling_w")).T),
        decoupling_b=_t(get("decoupling_b")),
        learnable_embedding=_t(get("learnable_embedding")),
        conv_out_fg_w=_t(np.asarray(get("conv_out_fg_w")).T),
        conv_out_fg_b=_t(get("conv_out_fg_b")),
        conv_out_bg_w=_t(np.asarray(get("conv_out_bg_w")).T),
        conv_out_bg_b=_t(get("conv_out_bg_b")),
    )


def decoder_to_jax(p: RevDecoderParams) -> Dict[str, np.ndarray]:
    """Port decoder params -> a dict of numpy arrays in the JAX layout, keyed
    by the JAX ``RevDecoderParams`` field names."""
    transposed = {"decoupling_w", "conv_out_fg_w", "conv_out_bg_w"}
    return {
        name: np.ascontiguousarray(_n(v).T) if name in transposed else _n(v)
        for name, v in p._asdict().items()
    }


def lora_from_jax(lora) -> list:
    """JAX ``init_lora`` adapters (numpy values) -> port adapters on the CPU."""
    return [{t: {"a": _t(np.asarray(e["a"]).T), "b": _t(np.asarray(e["b"]).T)} for t, e in layer.items()}
            for layer in lora]


def lora_to_jax(lora) -> list:
    """Port adapters -> numpy adapters in the JAX layout."""
    return [{t: {"a": np.ascontiguousarray(_n(e["a"]).T), "b": np.ascontiguousarray(_n(e["b"]).T)}
             for t, e in layer.items()}
            for layer in lora]


# the refiner's leaves held (in, out) in JAX and (out, in) in the port; the
# depthwise kernel is HWIO (7, 7, 1, E) in JAX and (E, 1, 7, 7) in the port
_REFINER_T = {("csf", "attn", "out", "w"), ("csf", "attn", "fc1", "w"), ("csf", "attn", "fc2", "w"),
              ("csf", "mask_dec", "w"), ("ge", "fuser0", "w"), ("ge", "fuser2", "w")}
_REFINER_DW = ("csf", "dw_conv", "w")


def _refiner_map(tree: Mapping[str, Any], leaf: Callable[[tuple, Any], Any], path: tuple = ()) -> Dict[str, Any]:
    return {k: _refiner_map(v, leaf, path + (k,)) if isinstance(v, Mapping) else leaf(path + (k,), v)
            for k, v in tree.items() if path + (k,) != ("num_heads",)}


def refiner_from_jax(tree: Mapping[str, Any]) -> Dict[str, Any]:
    """JAX ``init_sparse_refiner`` / ``load_refiner_checkpoint`` params
    (numpy values) -> port refiner params on the CPU (``num_heads`` is an
    argument of the port's forward, not a leaf)."""
    def leaf(path, v):
        a = np.asarray(v, np.float32)
        if path in _REFINER_T:
            a = a.T
        elif path == _REFINER_DW:
            a = np.transpose(a, (3, 2, 0, 1))
        return _t(a)

    return _refiner_map(tree, leaf)


def refiner_to_jax(params: Mapping[str, Any], num_heads: int = 8) -> Dict[str, Any]:
    """Port refiner params -> numpy params in the JAX layout, with the JAX
    tree's ``num_heads`` leaf."""
    def leaf(path, v):
        a = v.detach().to("cpu", torch.float32).numpy()
        if path in _REFINER_T:
            a = a.T
        elif path == _REFINER_DW:
            a = np.transpose(a, (2, 3, 1, 0))
        return a.copy(order="C")  # (np.ascontiguousarray would make the 0-d GE.alpha (1,))

    return {**_refiner_map(params, leaf), "num_heads": np.int32(num_heads)}


def _discriminator_map(params, stats, conv, kernel, linear):
    """Map a discriminator (params, stats) pair, key order kept: ``kernel``
    on the convolution kernels, ``linear`` on the linear weight, ``conv`` on
    every other array."""
    def block(p):
        return {k: kernel(v) if k == "conv_w" else conv(v) for k, v in p.items()}

    new_p = {}
    for name, v in params.items():
        if name == "convs":
            new_p[name] = [block(x) for x in v]
        elif name == "linear_w":
            new_p[name] = linear(v)
        elif name == "linear_b":
            new_p[name] = conv(v)
        else:
            new_p[name] = block(v)
    new_s = {name: [{k: conv(x) for k, x in s.items()} for s in v] if name == "convs"
             else {k: conv(x) for k, x in v.items()} for name, v in stats.items()}
    return new_p, new_s


def discriminator_from_jax(params, stats):
    """JAX ``init_discriminator`` (params, stats) (numpy values) -> port
    (params, stats) on the CPU: kernels HWIO -> OIHW, linear (flat, 1) ->
    (1, flat)."""
    return _discriminator_map(params, stats, _t, lambda w: _t(np.transpose(np.asarray(w), (3, 2, 0, 1))),
                              lambda w: _t(np.asarray(w).T))


def discriminator_to_jax(params, stats):
    """Port discriminator (params, stats) -> numpy trees in the JAX layout
    (inverse of :func:`discriminator_from_jax`)."""
    return _discriminator_map(params, stats, _n, lambda w: np.ascontiguousarray(np.transpose(_n(w), (2, 3, 1, 0))),
                              lambda w: np.ascontiguousarray(_n(w).T))


# ---------------------------------------------------------------------------
# training state <-> the JAX package's TrainState tree (its state files)
# ---------------------------------------------------------------------------


def _get(tree, key):
    """``tree[key]`` of a dict, ``tree.key`` of a NamedTuple (the JAX
    package's TrainState and optax states)."""
    return tree[key] if isinstance(tree, Mapping) else getattr(tree, key)


def _leaves_like(ref: Any, tree: Any) -> list:
    """The leaves of ``tree`` in the order of ``ref``'s leaves, matched by
    key, field or index (not by position in a dict)."""
    if isinstance(ref, torch.Tensor):
        return [tree]
    if isinstance(ref, RevDecoderParams):
        return [x for f, r in zip(ref._fields, ref) for x in _leaves_like(r, _get(tree, f))]
    if isinstance(ref, Mapping):
        return [x for k, r in ref.items() for x in _leaves_like(r, tree[k])]
    if len(ref) != len(tree):
        raise ValueError(f"tree of {len(tree)} entries where {len(ref)} are expected")
    return [x for r, t in zip(ref, tree) for x in _leaves_like(r, t)]


def _dis_to_jax(tree):
    return discriminator_to_jax(tree, {})[0]


def _dis_from_jax(tree):
    return discriminator_from_jax(tree, {})[0]


def _adamw_to_jax(opt, params, to_jax) -> list:
    """An ``engine.train_step.Optimizer`` over the leaves of ``params`` ->
    the state of optax's ``adamw`` chain: ``[ScaleByAdamState(count, mu,
    nu), EmptyState(), ScaleByScheduleState(count)]`` as ``[{"count", "mu",
    "nu"}, {}, {"count"}]``, numpy in the JAX layout.  AdamW's per-parameter
    ``step`` is the adam count (one int32 for every leaf, as optax keeps
    it) and StepLR's ``last_epoch`` the schedule's."""
    if any(a is not b for a, b in zip(opt.params, tree_leaves(params), strict=True)):
        raise ValueError("the optimizer does not hold the leaves of this params tree")
    mu, nu = opt.moments()

    def like_params(tensors):
        it = iter(tensors)
        return to_jax(tree_map(lambda _: next(it), params))

    return [{"count": np.int32(opt.count), "mu": like_params(mu), "nu": like_params(nu)}, {},
            {"count": np.int32(opt.schedule.last_epoch)}]


def _adamw_from_jax(opt, params, state, from_jax) -> None:
    """Load the optax ``adamw`` chain state ``state`` (what
    :func:`_adamw_to_jax` gives, or the JAX package's own) into ``opt``."""
    adam, schedule = state[0], state[2]
    count = int(_get(adam, "count"))
    mu = _leaves_like(params, from_jax(_get(adam, "mu")))
    nu = _leaves_like(params, from_jax(_get(adam, "nu")))
    opt.load(count, mu, nu, int(_get(schedule, "count")))


def train_state_to_jax(state) -> Dict[str, Any]:
    """A port ``TrainState`` -> the JAX package's ``TrainState`` as a numpy
    tree (``decoder``, ``decoder_ema``, ``opt_state``, ``dis_params``,
    ``dis_stats``, ``dis_opt_state``, ``ema_step``): the keys, dtypes and
    shapes of its state files."""
    dis_p, dis_s = discriminator_to_jax(state.dis_params, state.dis_stats)
    return {
        "decoder": decoder_to_jax(state.decoder),
        "decoder_ema": decoder_to_jax(state.decoder_ema),
        "opt_state": _adamw_to_jax(state.opt, state.decoder, decoder_to_jax),
        "dis_params": dis_p,
        "dis_stats": dis_s,
        "dis_opt_state": _adamw_to_jax(state.dis_opt, state.dis_params, _dis_to_jax),
        "ema_step": np.int32(state.ema_step),
    }


def train_state_from_jax(tree: Any, train_cfg, device):
    """The JAX package's ``TrainState`` (a numpy tree, or the NamedTuple
    with numpy leaves) -> a port ``TrainState`` on ``device`` with the
    optimizers of ``train_cfg`` at the tree's step counts and moments."""
    from ucod_dpl_tpu_torch.engine.train_step import init_train_state

    dis_p, dis_s = discriminator_from_jax(_get(tree, "dis_params"), _get(tree, "dis_stats"))
    state = init_train_state(decoder_from_jax(_get(tree, "decoder")), decoder_from_jax(_get(tree, "decoder_ema")),
                             dis_p, dis_s, train_cfg, device)
    _adamw_from_jax(state.opt, state.decoder, _get(tree, "opt_state"), decoder_from_jax)
    _adamw_from_jax(state.dis_opt, state.dis_params, _get(tree, "dis_opt_state"), _dis_from_jax)
    state.ema_step = int(_get(tree, "ema_step"))
    return state


def lora_state_to_jax(lora, opt) -> Dict[str, Any]:
    """Adapters and their optimizer -> the JAX train loop's LoRA pair
    ``{"lora": adapters, "opt": adamw state}`` (its ``state_*_lora`` files)."""
    return {"lora": lora_to_jax(lora), "opt": _adamw_to_jax(opt, lora, lora_to_jax)}


def lora_state_from_jax(tree: Any, cfg, device):
    """The JAX train loop's LoRA pair -> (adapters requiring grad on
    ``device``, their optimizer at the pair's step counts and moments)."""
    from ucod_dpl_tpu_torch.engine.train_step import make_lora_optimizer

    lora = tree_map(lambda t: t.to(device).requires_grad_(True), lora_from_jax(_get(tree, "lora")))
    opt = make_lora_optimizer(lora, cfg)
    _adamw_from_jax(opt, lora, _get(tree, "opt"), lora_from_jax)
    return lora, opt
