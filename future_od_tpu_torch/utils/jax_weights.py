"""Weight bridge: the JAX package's flagship variables -> this port's state_dict.

Input: `{"params": ..., "frozen": ...}` as nested dicts of numpy arrays (what
`jax.tree.map(np.asarray, variables)` gives for `build_flagship(args)`).
Output: a state_dict keyed by the reference PyTorch checkpoint's names, which
are this port's parameter names — the exact inverse of
future_od_tpu/utils/checkpoint_convert.py::convert_reference_checkpoint.
Layout changes:
- flax kernel (in, out) -> Linear weight (out, in);
- conv kernel HWIO -> OIHW;
- LayerNorm `scale` -> `weight`;
- separate q/k/v projections -> packed `in_proj_weight` / `in_proj_bias`;
- frozen BN statistics -> the FrozenBatchNorm2d buffers.
A reference `.pth.tar`'s `net` state_dict loads into the port directly with
`load_state_dict`.

`load_jax_train_state` carries a JAX training run over: the weights, and
optax's AdamW moments and step count into the torch optimizer, through the
same name map, so the run continues in the port.
"""
from __future__ import annotations

from typing import Any, Dict, List, Mapping

import numpy as np
import torch

from future_od_tpu_torch.utils.device import DeviceLike, resolve_device

Tree = Mapping[str, Any]
BN_KEYS = ("weight", "bias", "running_mean", "running_var")


def _linear(sd: Dict[str, np.ndarray], prefix: str, p: Tree) -> None:
    sd[f"{prefix}.weight"] = np.asarray(p["kernel"]).T
    if "bias" in p:
        sd[f"{prefix}.bias"] = np.asarray(p["bias"])


def _layernorm(sd, prefix, p: Tree) -> None:
    sd[f"{prefix}.weight"] = np.asarray(p["scale"])
    sd[f"{prefix}.bias"] = np.asarray(p["bias"])


def _mlp(sd, prefix, p: Tree) -> None:
    for name, layer in p.items():  # layer{i}
        _linear(sd, f"{prefix}.layers.{int(name[len('layer'):])}", layer)


def _feedforward(sd, prefix, p: Tree) -> None:
    _linear(sd, f"{prefix}.0", p["fc1"])
    _linear(sd, f"{prefix}.3", p["fc2"])


def _conv(sd, prefix, kernel) -> None:
    sd[f"{prefix}.weight"] = np.asarray(kernel).transpose(3, 2, 0, 1)


def _bn(sd, prefix, frozen: Tree) -> None:
    for key in BN_KEYS:
        sd[f"{prefix}.{key}"] = np.asarray(frozen[key])


def _head_attention(sd, prefix, p: Tree) -> None:
    """SlotToSlot / SlotToImage / Egodeep attention: the caller-side
    projections as they are, `out_proj` under the reference's `fun.`."""
    for name, sub in p.items():
        if name == "out_proj":
            _linear(sd, f"{prefix}.fun.out_proj", sub)
        elif name in ("norm1", "norm2"):
            _layernorm(sd, f"{prefix}.{name}", sub)
        elif name == "mlp":
            _feedforward(sd, f"{prefix}.mlp", sub)
        else:
            _linear(sd, f"{prefix}.{name}", sub)


def _encoder_attention(sd, prefix, p: Tree) -> None:
    attn = p["attn"]
    qkv = [attn[k] for k in ("q_proj", "k_proj", "v_proj")]
    sd[f"{prefix}.attn.in_proj_weight"] = np.concatenate(
        [np.asarray(x["kernel"]).T for x in qkv], axis=0
    )
    sd[f"{prefix}.attn.in_proj_bias"] = np.concatenate([np.asarray(x["bias"]) for x in qkv])
    _linear(sd, f"{prefix}.attn.out_proj", attn["out_proj"])
    _layernorm(sd, f"{prefix}.norm1", p["norm1"])
    _layernorm(sd, f"{prefix}.norm2", p["norm2"])
    _feedforward(sd, f"{prefix}.mlp", p["mlp"])


STEM_KERNEL_SHAPES = ((7, 7, 3, 64), (4, 4, 12, 64))  # the 7x7 stem, the space_to_depth one


def _resnet_body(sd, prefix, params: Tree, frozen: Tree) -> None:
    if np.shape(params["conv1"]["kernel"]) not in STEM_KERNEL_SHAPES:
        raise ValueError(f"stem kernel {np.shape(params['conv1']['kernel'])}; "
                         f"want one of {STEM_KERNEL_SHAPES}")
    _conv(sd, f"{prefix}.conv1", params["conv1"]["kernel"])
    _bn(sd, f"{prefix}.bn1", frozen["bn1"])
    for name, block in params.items():
        if not name.startswith("layer"):
            continue
        stage, idx = name[len("layer"):].split("_block")
        out = f"{prefix}.layer{stage}.{idx}"
        for i in (1, 2, 3):
            _conv(sd, f"{out}.conv{i}", block[f"conv{i}"]["kernel"])
            _bn(sd, f"{out}.bn{i}", frozen[name][f"bn{i}"])
        if "downsample_conv" in block:
            _conv(sd, f"{out}.downsample.0", block["downsample_conv"]["kernel"])
            _bn(sd, f"{out}.downsample.1", frozen[name]["downsample_bn"])


def _encoder_layer(sd, prefix, p: Tree) -> None:
    _encoder_attention(sd, f"{prefix}.self_attn", p["self_attn"])
    if "egodeep_attend" in p:
        _head_attention(sd, f"{prefix}.egodeep_attend", p["egodeep_attend"])
        _layernorm(sd, f"{prefix}.norm_eda", p["norm_eda"])


def _decoder_layer(sd, prefix, p: Tree) -> None:
    _head_attention(sd, f"{prefix}.self_attend", p["self_attend"])
    _layernorm(sd, f"{prefix}.norm_sa", p["norm_sa"])
    _feedforward(sd, f"{prefix}.feedforward", p["feedforward"])
    _layernorm(sd, f"{prefix}.norm_out", p["norm_out"])
    j = 0
    while f"image_attend{j}" in p:
        _head_attention(sd, f"{prefix}.image_attend.{j}", p[f"image_attend{j}"])
        _layernorm(sd, f"{prefix}.norm_ia.{j}", p[f"norm_ia{j}"])
        j += 1
    if "egodeep_attend" in p:
        _head_attention(sd, f"{prefix}.egodeep_attend", p["egodeep_attend"])
        _layernorm(sd, f"{prefix}.norm_eda", p["norm_eda"])


def flagship_state_arrays(variables: Tree) -> Dict[str, np.ndarray]:
    """The port's state_dict for the JAX flagship's variables, as numpy
    arrays (the layout work; `jax_to_state_dict` makes tensors of it)."""
    core_p = variables["params"]["core"]
    core_f = variables["frozen"]["core"]
    sd: Dict[str, np.ndarray] = {}

    sep, sep_p = "_model.separate_encoder", core_p["separate_encoder"]
    _resnet_body(sd, f"{sep}.backbone.body", sep_p["backbone"]["body"],
                 core_f["separate_encoder"]["backbone"]["body"])
    _conv(sd, f"{sep}.backbone.input_proj", sep_p["backbone"]["input_proj"]["kernel"])
    sd[f"{sep}.backbone.input_proj.bias"] = np.asarray(sep_p["backbone"]["input_proj"]["bias"])
    _linear(sd, f"{sep}.imu_layers.0", sep_p["imu_layers"]["fc1"])
    _linear(sd, f"{sep}.imu_layers.2", sep_p["imu_layers"]["fc2"])
    for name, layer in sep_p.get("transformer", {}).items():
        _encoder_layer(sd, f"{sep}.transformer.layers.{int(name[len('layer'):])}", layer)

    det, det_p = "_model.detector", core_p["detector"]
    _linear(sd, f"{det}.class_embed", det_p["class_embed"])
    _mlp(sd, f"{det}.bbox_embed", det_p["bbox_embed"])
    sd[f"{det}.query_embed.weight"] = np.asarray(det_p["query_embed"]["embedding"])
    dec, dec_p = f"{det}.decoder", det_p["decoder"]
    if "query_scale" in dec_p:  # absent from a one-layer decoder
        _mlp(sd, f"{dec}.query_scale", dec_p["query_scale"])
    _mlp(sd, f"{dec}.ref_point_head", dec_p["ref_point_head"])
    _layernorm(sd, f"{dec}.norm", dec_p["norm"])
    for name, layer in dec_p.items():
        if name.startswith("layer"):
            _decoder_layer(sd, f"{dec}.layers.{int(name[len('layer'):])}", layer)
    return sd


def jax_to_state_dict(variables: Tree, device: DeviceLike = None) -> Dict[str, torch.Tensor]:
    """The port's state_dict for the JAX flagship's variables, as tensors on
    `device` (default CUDA; raises without a card)."""
    device = resolve_device(device)
    return {
        k: torch.from_numpy(np.array(v, dtype=np.float32)).to(device)
        for k, v in flagship_state_arrays(variables).items()
    }


def load_jax_variables(model: torch.nn.Module, variables: Tree) -> torch.nn.Module:
    """Load the JAX flagship's variables into a port flagship (strict: every
    parameter and buffer must be matched) on the model's own device."""
    device = next(model.parameters()).device
    model.load_state_dict(jax_to_state_dict(variables, device=device), strict=True)
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
    """Load the JAX flagship's variables ({"params", "frozen"}) into `model`
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
        key: flagship_state_arrays(
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
