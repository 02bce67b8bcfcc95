"""Weight bridge: the JAX package's variables -> this port's state_dict, for
every model the JAX package builds (the flagship, the joint-encoder
ablations, the single-frame core, the tracker baseline, the detector modes).

Input: `{"params": ..., "frozen": ...}` as nested dicts of numpy arrays (what
`jax.tree.map(np.asarray, variables)` gives), with the `"quant"` collection
of a static-int8 model (`int8_static`: its calibrated per-channel ranges,
which a JAX init computes). Output: a state_dict keyed by the reference
PyTorch checkpoint's names, which are this port's parameter names (the
inverse of future_od_tpu/utils/checkpoint_convert.py::
convert_reference_checkpoint, for the modules that converter knows).
Layout changes:
- flax kernel (in, out) -> Linear weight (out, in);
- conv kernel HWIO -> OIHW;
- LayerNorm `scale` -> `weight`;
- separate q/k/v projections -> packed `in_proj_weight` / `in_proj_bias`;
- frozen BN statistics -> the FrozenBatchNorm2d buffers;
- the "quant" ranges `body/conv1_amax` and `body/layer{s}_block{b}/<conv>_amax`
  -> `body.conv1_amax` and `body.layer{s}.{b}.<conv>_amax`;
- the modules the reference has no names for keep the JAX names, with
  indices as ModuleList entries: `previmage_attn{i}` -> `previmage_attn.{i}`,
  the F2F encoder's `conv{i}` -> `convs.{i}`.
The converter raises on a JAX leaf it cannot place, and `load_jax_variables`
on a port parameter the variables leave unfilled, so a model whose tree
differs from the JAX one cannot load quietly. A reference `.pth.tar`'s `net`
state_dict loads into the port directly with `load_state_dict`.

`load_jax_train_state` carries a JAX training run over: the weights, and
optax's AdamW moments and step count into the torch optimizer, through the
same name map, so the run continues in the port.
"""
from __future__ import annotations

import re
from typing import Any, Dict, List, Mapping

import numpy as np
import torch

from future_od_tpu_torch.utils.device import DeviceLike, resolve_device

Tree = Mapping[str, Any]
BN_KEYS = ("weight", "bias", "running_mean", "running_var")


class _Leaves:
    """The variables' leaves by '/'-joined path (`params/core/...`,
    `frozen/core/...`, `quant/core/...`); each is taken once, and `left()`
    names the rest."""

    def __init__(self, variables: Tree):
        self.flat: Dict[str, Any] = {}
        for collection, tree in variables.items():
            if collection not in ("params", "frozen", "quant"):
                raise ValueError(f"cannot place the JAX collection {collection!r}")
            self._flatten(collection, tree)

    def _flatten(self, prefix: str, tree) -> None:
        if isinstance(tree, Mapping):
            for key, value in tree.items():
                self._flatten(f"{prefix}/{key}", value)
        else:
            self.flat[prefix] = tree

    def take(self, path: str) -> np.ndarray:
        return np.asarray(self.flat.pop(path))

    def has(self, path: str) -> bool:
        return any(k == path or k.startswith(path + "/") for k in self.flat)

    def children(self, path: str, pattern: str) -> List[int]:
        """The indices i of the children `<path>/<pattern>{i}`, sorted."""
        regex = re.compile(re.escape(path) + "/" + pattern + r"(\d+)(/|$)")
        return sorted({int(m.group(1)) for k in self.flat if (m := regex.match(k))})

    def left(self) -> List[str]:
        return sorted(self.flat)


def _linear(sd, prefix: str, v: _Leaves, src: str) -> None:
    sd[f"{prefix}.weight"] = v.take(f"{src}/kernel").T
    if v.has(f"{src}/bias"):
        sd[f"{prefix}.bias"] = v.take(f"{src}/bias")


def _layernorm(sd, prefix, v: _Leaves, src: str) -> None:
    sd[f"{prefix}.weight"] = v.take(f"{src}/scale")
    sd[f"{prefix}.bias"] = v.take(f"{src}/bias")


def _mlp(sd, prefix, v: _Leaves, src: str) -> None:
    for i in v.children(src, "layer"):
        _linear(sd, f"{prefix}.layers.{i}", v, f"{src}/layer{i}")


def _feedforward(sd, prefix, v: _Leaves, src: str) -> None:
    _linear(sd, f"{prefix}.0", v, f"{src}/fc1")
    _linear(sd, f"{prefix}.3", v, f"{src}/fc2")


def _conv(sd, prefix, v: _Leaves, src: str) -> None:
    sd[f"{prefix}.weight"] = v.take(f"{src}/kernel").transpose(3, 2, 0, 1)
    if v.has(f"{src}/bias"):
        sd[f"{prefix}.bias"] = v.take(f"{src}/bias")


def _bn(sd, prefix, v: _Leaves, src: str) -> None:
    for key in BN_KEYS:
        sd[f"{prefix}.{key}"] = v.take(f"{src}/{key}")


HEAD_PROJECTIONS = ("query_content", "query_pos", "query_sine", "key_content", "key_pos",
                    "key", "value")


def _head_attention(sd, prefix, v: _Leaves, src: str) -> None:
    """SlotToSlot / SlotToImage / Egodeep attention: the caller-side
    projections as they are, `out_proj` under the reference's `fun.`, the
    encoder flavour's norms and MLP."""
    for name in HEAD_PROJECTIONS:
        if v.has(f"{src}/{name}"):
            _linear(sd, f"{prefix}.{name}", v, f"{src}/{name}")
    _linear(sd, f"{prefix}.fun.out_proj", v, f"{src}/out_proj")
    if v.has(f"{src}/mlp"):
        _layernorm(sd, f"{prefix}.norm1", v, f"{src}/norm1")
        _layernorm(sd, f"{prefix}.norm2", v, f"{src}/norm2")
        _feedforward(sd, f"{prefix}.mlp", v, f"{src}/mlp")


def _encoder_attention(sd, prefix, v: _Leaves, src: str) -> None:
    qkv = [f"{src}/attn/{k}" for k in ("q_proj", "k_proj", "v_proj")]
    sd[f"{prefix}.attn.in_proj_weight"] = np.concatenate(
        [v.take(f"{x}/kernel").T for x in qkv], axis=0)
    sd[f"{prefix}.attn.in_proj_bias"] = np.concatenate([v.take(f"{x}/bias") for x in qkv])
    _linear(sd, f"{prefix}.attn.out_proj", v, f"{src}/attn/out_proj")
    _layernorm(sd, f"{prefix}.norm1", v, f"{src}/norm1")
    _layernorm(sd, f"{prefix}.norm2", v, f"{src}/norm2")
    _feedforward(sd, f"{prefix}.mlp", v, f"{src}/mlp")


STEM_KERNEL_SHAPES = ((7, 7, 3, 64), (4, 4, 12, 64))  # the 7x7 stem, the space_to_depth one


INT8_CONVS = ("conv1", "conv2", "conv3", "downsample_conv")  # a block's static-int8 ranges


def _amax(sd, key: str, v: _Leaves, src: str) -> None:
    if v.has(src):
        sd[key] = v.take(src)


def _resnet_body(sd, prefix, v: _Leaves, src: str) -> None:
    params, frozen, quant = f"params/{src}", f"frozen/{src}", f"quant/{src}"
    stem = np.shape(v.flat[f"{params}/conv1/kernel"])
    if stem not in STEM_KERNEL_SHAPES:
        raise ValueError(f"stem kernel {stem}; want one of {STEM_KERNEL_SHAPES}")
    _conv(sd, f"{prefix}.conv1", v, f"{params}/conv1")
    _bn(sd, f"{prefix}.bn1", v, f"{frozen}/bn1")
    _amax(sd, f"{prefix}.conv1_amax", v, f"{quant}/conv1_amax")
    blocks = sorted({k[len(params) + 1:].split("/")[0] for k in v.flat
                     if k.startswith(params + "/layer")})
    for name in blocks:
        stage, idx = name[len("layer"):].split("_block")
        out = f"{prefix}.layer{stage}.{idx}"
        for i in (1, 2, 3):
            _conv(sd, f"{out}.conv{i}", v, f"{params}/{name}/conv{i}")
            _bn(sd, f"{out}.bn{i}", v, f"{frozen}/{name}/bn{i}")
        if v.has(f"{params}/{name}/downsample_conv"):
            _conv(sd, f"{out}.downsample.0", v, f"{params}/{name}/downsample_conv")
            _bn(sd, f"{out}.downsample.1", v, f"{frozen}/{name}/downsample_bn")
        for conv in INT8_CONVS:
            _amax(sd, f"{out}.{conv}_amax", v, f"{quant}/{name}/{conv}_amax")


def _encoder(sd, prefix, v: _Leaves, src: str) -> None:
    """A TransformerEncoder's layers: self, prevout and frame-memory
    attentions, egodeep attention."""
    for i in v.children(src, "layer"):
        out, layer = f"{prefix}.layers.{i}", f"{src}/layer{i}"
        _encoder_attention(sd, f"{out}.self_attn", v, f"{layer}/self_attn")
        if v.has(f"{layer}/prevout_attn"):
            _encoder_attention(sd, f"{out}.prevout_attn", v, f"{layer}/prevout_attn")
        for j in v.children(layer, "previmage_attn"):
            _encoder_attention(sd, f"{out}.previmage_attn.{j}", v, f"{layer}/previmage_attn{j}")
        if v.has(f"{layer}/egodeep_attend"):
            _head_attention(sd, f"{out}.egodeep_attend", v, f"{layer}/egodeep_attend")
            _layernorm(sd, f"{out}.norm_eda", v, f"{layer}/norm_eda")


def _decoder_layer(sd, prefix, v: _Leaves, src: str) -> None:
    _head_attention(sd, f"{prefix}.self_attend", v, f"{src}/self_attend")
    _layernorm(sd, f"{prefix}.norm_sa", v, f"{src}/norm_sa")
    _feedforward(sd, f"{prefix}.feedforward", v, f"{src}/feedforward")
    _layernorm(sd, f"{prefix}.norm_out", v, f"{src}/norm_out")
    for j in v.children(src, "image_attend"):
        _head_attention(sd, f"{prefix}.image_attend.{j}", v, f"{src}/image_attend{j}")
        _layernorm(sd, f"{prefix}.norm_ia.{j}", v, f"{src}/norm_ia{j}")
    if v.has(f"{src}/slotstates_attend"):
        _head_attention(sd, f"{prefix}.slotstates_attend", v, f"{src}/slotstates_attend")
        _layernorm(sd, f"{prefix}.norm_ssa", v, f"{src}/norm_ssa")
    if v.has(f"{src}/egodeep_attend"):
        _head_attention(sd, f"{prefix}.egodeep_attend", v, f"{src}/egodeep_attend")
        _layernorm(sd, f"{prefix}.norm_eda", v, f"{src}/norm_eda")


def state_arrays(variables: Tree) -> Dict[str, np.ndarray]:
    """The port's state_dict for the JAX model's variables, as numpy arrays
    (the layout work; `jax_to_state_dict` makes tensors of it). Raises
    ValueError naming every JAX leaf it cannot place."""
    v = _Leaves(variables)
    sd: Dict[str, np.ndarray] = {}

    sep, src = "_model.separate_encoder", "core/separate_encoder"
    _resnet_body(sd, f"{sep}.backbone.body", v, f"{src}/backbone/body")
    _conv(sd, f"{sep}.backbone.input_proj", v, f"params/{src}/backbone/input_proj")
    if v.has(f"params/{src}/imu_layers"):
        _linear(sd, f"{sep}.imu_layers.0", v, f"params/{src}/imu_layers/fc1")
        _linear(sd, f"{sep}.imu_layers.2", v, f"params/{src}/imu_layers/fc2")
    _encoder(sd, f"{sep}.transformer", v, f"params/{src}/transformer")

    joint = "params/core/joint_encoder"
    _encoder(sd, "_model.joint_encoder.transformer", v, f"{joint}/transformer")
    for i in v.children(joint, "conv"):
        _conv(sd, f"_model.joint_encoder.convs.{i}", v, f"{joint}/conv{i}")

    det, src = "_model.detector", "params/core/detector"
    _linear(sd, f"{det}.class_embed", v, f"{src}/class_embed")
    _mlp(sd, f"{det}.bbox_embed", v, f"{src}/bbox_embed")
    sd[f"{det}.query_embed.weight"] = v.take(f"{src}/query_embed/embedding")
    dec, src = f"{det}.decoder", f"{src}/decoder"
    _mlp(sd, f"{dec}.query_scale", v, f"{src}/query_scale")  # absent from some decoders
    _mlp(sd, f"{dec}.ref_point_head", v, f"{src}/ref_point_head")
    _layernorm(sd, f"{dec}.norm", v, f"{src}/norm")
    for i in v.children(src, "layer"):
        _decoder_layer(sd, f"{dec}.layers.{i}", v, f"{src}/layer{i}")
    if v.left():
        raise ValueError(f"JAX variables the weight bridge cannot place: {v.left()}")
    return sd


# the name under which the flagship's callers know it
flagship_state_arrays = state_arrays


def jax_to_state_dict(variables: Tree, device: DeviceLike = None) -> Dict[str, torch.Tensor]:
    """The port's state_dict for the JAX model's variables, as tensors on
    `device` (default CUDA; raises without a card)."""
    device = resolve_device(device)
    return {
        k: torch.from_numpy(np.array(v, dtype=np.float32)).to(device)
        for k, v in state_arrays(variables).items()
    }


def load_jax_variables(model: torch.nn.Module, variables: Tree) -> torch.nn.Module:
    """Load the JAX model's variables into the port's model of the same
    build, on the model's own device. Raises ValueError when the trees
    differ: a JAX leaf the bridge cannot place, a port parameter or buffer
    the variables leave unfilled, or one they fill that the model lacks."""
    device = next(model.parameters()).device
    sd = jax_to_state_dict(variables, device=device)
    own = model.state_dict()
    unfilled, extra = sorted(set(own) - set(sd)), sorted(set(sd) - set(own))
    if unfilled or extra:
        raise ValueError(f"the JAX variables leave these port parameters unfilled: {unfilled}; "
                         f"they fill these the port model lacks: {extra}")
    model.load_state_dict(sd, strict=True)
    return model


def _is_array(x) -> bool:
    return hasattr(x, "shape") and hasattr(x, "dtype")


def _adam_states(node):
    """Every optax ScaleByAdamState (a node with count, mu and nu) inside an
    opt_state, found by walking its tuples, NamedTuples and dicts."""
    if all(hasattr(node, f) for f in ("count", "mu", "nu")):
        yield node
    elif isinstance(node, dict):
        for child in node.values():
            yield from _adam_states(child)
    elif isinstance(node, (tuple, list)):
        for child in node:
            yield from _adam_states(child)


def _merge(trees, like):
    """One params-shaped tree from per-group moment trees, whose leaves are
    arrays where the group trains the parameter and optax MaskedNodes
    elsewhere; a parameter no group trains gets zeros."""
    if isinstance(like, Mapping):
        return {k: _merge([t[k] for t in trees], v) for k, v in like.items()}
    for t in trees:
        if _is_array(t):
            return np.asarray(t)
    return np.zeros(np.shape(like), np.float32)


def load_jax_train_state(model: torch.nn.Module, optimizer: torch.optim.Optimizer,
                         variables: Tree, opt_state: Any) -> None:
    """Load the JAX model's variables ({"params", "frozen"}) into `model`
    and the state of the JAX package's optimizer (`build_optimizer`'s
    opt_state after some steps) into `optimizer` (the port's
    `build_optimizer` over that model): per parameter, optax's mu / nu
    become exp_avg / exp_avg_sq and its count the step; the injected
    learning rates become the groups' lrs."""
    load_jax_variables(model, variables)
    adam = list(_adam_states(opt_state))
    if not adam:
        raise ValueError("no AdamW state (count, mu, nu) in opt_state")
    params = variables["params"]
    moments = {
        key: state_arrays(
            {"params": _merge([getattr(s, key) for s in adam], params),
             "frozen": variables["frozen"]}
        )
        for key in ("mu", "nu")
    }
    step = float(np.asarray(adam[0].count))
    names = {p: n for n, p in model.named_parameters()}
    for group in optimizer.param_groups:
        for p in group["params"]:
            name = names[p]
            optimizer.state[p] = {
                "step": torch.tensor(step, dtype=torch.float32),
                "exp_avg": torch.from_numpy(np.array(moments["mu"][name], np.float32)).to(p.device),
                "exp_avg_sq": torch.from_numpy(np.array(moments["nu"][name], np.float32)).to(p.device),
            }
    hyper = getattr(opt_state, "hyperparams", None)
    if hyper:
        rates = {"main": hyper.get("lr_main"), "backbone": hyper.get("lr_bb")}
        for group in optimizer.param_groups:
            if rates.get(group.get("name")) is not None:
                group["lr"] = float(np.asarray(rates[group["name"]]))


def blocks_from_numpy(blocks, dtype: torch.dtype = torch.float32,
                      device: DeviceLike = None) -> List[Dict[str, torch.Tensor]]:
    """Bottleneck weights in the kernel-study tools' layout (a list of
    dicts w1 (in, out), b1, w2 HWIO, b2, w3, b3 [, wd, bd] of numpy arrays,
    as tools/bench_fused_bottleneck.py::make_layer1_blocks makes them) as
    tensors of `dtype` on `device` (default CUDA; raises without a card).
    The layout is the port's own, so no other conversion is needed."""
    device = resolve_device(device)
    return [{k: torch.from_numpy(np.asarray(v, np.float32)).to(device, dtype)
             for k, v in bk.items()} for bk in blocks]
