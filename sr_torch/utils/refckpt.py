"""Reference-format checkpoints: ``<Model>_param.pkl`` in and out.

The reference collection saves each model as ``torch.save(state_dict)`` of
its ``Net`` (reference: every wrapper's ``save_model``). This module writes
a port model's weights as that state dict, under the reference's module
names and in its registration order, and reads one back. It is the port's
copy of the JAX package's ``sr/utils/torch_interop.py``
(``reference_plan``, ``discriminator_plan``, ``import_state_dict``,
``export_reference_checkpoint``): the same plans, whose flax paths name the
port's modules too (``sr_torch/utils/interop.py:flax_path``), and the key
names that ``export_reference_checkpoint`` writes through the JAX package's
PyTorch replicas of the reference nets (``reference_names``).

Atoms pair POSITIONALLY with the state dict's registration order; loading
refuses a count or a shape that does not fit, naming the atom. Conventions:

* conv and linear weights are torch's own layout in both (the port's
  modules are torch modules); a conv without a bias in the reference
  (VDSR's) has none in the port either.
* A transposed conv's weight is flax's kernel flipped in space, which is
  what the port's ``ConvTranspose2d`` already holds (FSRCNN, LapSRN).
* DRCN's bare ``recursion_weights`` parameter comes FIRST: a torch module's
  own parameters precede its children's in its state dict (``w``).
* SRGAN's discriminator flattens NHWC features before its first dense
  layer, the reference NCHW (``dense_nhwc`` permutes the weight's columns).
* A batch norm's ``scale``/``bias`` and ``mean``/``var`` buffers are
  ``weight``/``bias``/``running_mean``/``running_var``, with a
  ``num_batches_tracked`` of 0, as a fresh ``BatchNorm2d`` holds.
* A PReLU has one shared slope, a (1,) ``weight``.
"""

from __future__ import annotations

import math
from collections import OrderedDict

import torch
from torch import nn

from sr_torch.utils.interop import flax_path


# ---------------------------------------------------------------------------
# plans: flax paths, which name the port's modules (sr/utils/torch_interop.py)
# ---------------------------------------------------------------------------


def convblock_plan(path: str, act: str | None = None, norm: str | None = None):
    """Atoms of one ConvBlock in forward order."""
    plan = [(f"{path}/Conv_0", "conv")]
    if norm == "batch":
        plan.append((f"{path}/_NormAct_0/BatchNorm_0", "bn"))
    if act == "prelu":
        plan.append((f"{path}/_NormAct_0/PReLU_0", "prelu"))
    return plan


def deconvblock_plan(path: str, act: str | None = None,
                     norm: str | None = None):
    """Atoms of one DeconvBlock in forward order."""
    plan = [(f"{path}/ConvTranspose_0", "deconv")]
    if norm == "batch":
        plan.append((f"{path}/_NormAct_0/BatchNorm_0", "bn"))
    if act == "prelu":
        plan.append((f"{path}/_NormAct_0/PReLU_0", "prelu"))
    return plan


def reference_plan(model_name: str, model: nn.Module) -> list[tuple]:
    """Atom plan of a reference ``<Model>_param.pkl``, its depths read off
    the port ``model``."""
    n = model_name.lower()
    if n == "srcnn":
        return [e for i in range(3) for e in convblock_plan(f"ConvBlock_{i}")]
    if n == "vdsr":
        return [e for i in range(model.num_layers)
                for e in convblock_plan(f"ConvBlock_{i}")]
    if n == "drcn":
        return (
            [("recursion_weights", "tensor")]
            + convblock_plan("ConvBlock_0") + convblock_plan("ConvBlock_1")
            + [("Scan_RecBlock_0/Conv_0", "conv")]
            + convblock_plan("Scan_RecBlock_0/ConvBlock_0")
            + [("Scan_RecBlock_0/Conv_1", "conv")]
        )
    if n == "espcn":
        return (convblock_plan("ConvBlock_0") + convblock_plan("ConvBlock_1")
                + [("Conv_0", "conv")])
    if n == "fsrcnn":
        return [e for i in range(model.num_convs)
                for e in convblock_plan(f"ConvBlock_{i}", act="prelu")
                ] + deconvblock_plan("DeconvBlock_0")
    if n == "edsr":
        plan = [("head/Conv_0", "conv")]
        for i in range(len(model.blocks)):
            plan += [(f"blocks_{i}/Conv_0", "conv"),
                     (f"blocks_{i}/Conv_1", "conv")]
        plan += [("body_conv/Conv_0", "conv")]
        plan += [(f"upsample_{i}/Conv_0", "conv")
                 for i in range(len(model.upsample))]
        return plan + [("out_conv/Conv_0", "conv")]
    if n in ("srresnet", "srgan"):
        plan = [("head", "conv"), ("head_act", "prelu")]
        for i in range(len(model.blocks)):
            p = f"blocks_{i}"
            plan += [
                (f"{p}/Conv_0", "conv"),
                (f"{p}/_NormAct_0/BatchNorm_0", "bn"),
                (f"{p}/_NormAct_0/PReLU_0", "prelu"),
                (f"{p}/Conv_1", "conv"),
                (f"{p}/BatchNorm_0", "bn"),
            ]
        plan += [("body_conv", "conv"), ("body_bn", "bn")]
        for i in range(len(model.upsample)):
            plan += convblock_plan(f"upsample_{i}", act="prelu")
        return plan + [("out_conv", "conv")]
    if n == "lapsrn":
        d = model.num_convs
        # flax call-order numbering: feat_in = CB_0; level L: branch convs
        # CB_{L(d+1)+1..+d}, branch deconv DB_{2L}, res conv CB_{L(d+1)+d+1},
        # image deconv DB_{2L+1}. The reference registers feat_in, every
        # branch, every res conv, every image deconv.
        plan = convblock_plan("ConvBlock_0")
        for lv in range(model.levels):
            base = lv * (d + 1)
            for j in range(1, d + 1):
                plan += convblock_plan(f"ConvBlock_{base + j}")
            plan += deconvblock_plan(f"DeconvBlock_{2 * lv}")
        for lv in range(model.levels):
            plan += convblock_plan(f"ConvBlock_{lv * (d + 1) + d + 1}")
        for lv in range(model.levels):
            plan += deconvblock_plan(f"DeconvBlock_{2 * lv + 1}")
        return plan
    raise ValueError(f"no reference plan for model {model_name!r}")


def discriminator_plan(hr_size: int, base_filter: int = 64) -> list[tuple]:
    """Atom plan of the SRGAN discriminator (reference:
    srgan.py:Discriminator) at a training HR crop size."""
    plan = convblock_plan("ConvBlock_0")
    for i in range(1, 8):
        plan += convblock_plan(f"ConvBlock_{i}", norm="batch")
    sp = hr_size // 16
    return plan + [("Dense_0", "dense_nhwc", (sp, sp, base_filter * 8)),
                   ("Dense_1", "dense")]


# ---------------------------------------------------------------------------
# the reference's module names, one per atom, in registration order
# ---------------------------------------------------------------------------


def reference_names(model_name: str, model: nn.Module) -> list[str]:
    """The reference ``Net``'s name of each atom of :func:`reference_plan`
    (the key prefix in its state dict), in the same order."""
    n = model_name.lower()
    if n in ("srcnn", "espcn"):
        return [f"net.{2 * i}" for i in range(3)]
    if n == "vdsr":
        return [f"net.{2 * i}" for i in range(model.num_layers)]
    if n == "drcn":
        return ["w", "embed.0", "embed.2", "rec", "recon1.0", "recon2"]
    if n == "fsrcnn":
        k = model.num_convs
        return ([f"net.{j}" for i in range(k) for j in (2 * i, 2 * i + 1)]
                + [f"net.{2 * k}"])
    if n == "edsr":
        return (["head"]
                + [f"blocks.{i}.{c}" for i in range(len(model.blocks))
                   for c in ("c1", "c2")]
                + ["body_conv"]
                + [f"upsample.{2 * i}" for i in range(len(model.upsample))]
                + ["out_conv"])
    if n in ("srresnet", "srgan"):
        return (["head", "head_act"]
                + [f"blocks.{i}.{c}" for i in range(len(model.blocks))
                   for c in ("c1", "bn1", "act", "c2", "bn2")]
                + ["body_conv", "body_bn"]
                + [f"upsample.{3 * i + j}" for i in range(len(model.upsample))
                   for j in (0, 2)]
                + ["out_conv"])
    if n == "lapsrn":
        d = model.num_convs
        names = ["feat_in.0"]
        for lv in range(model.levels):
            names += [f"feat_branches.{lv}.{2 * j}" for j in range(d + 1)]
        names += [f"res_convs.{lv}" for lv in range(model.levels)]
        return names + [f"img_deconvs.{lv}" for lv in range(model.levels)]
    raise ValueError(f"no reference names for model {model_name!r}")


def discriminator_names() -> list[str]:
    """The reference discriminator's name of each atom of
    :func:`discriminator_plan`: an 8-conv ``tower`` (conv, [BN], LeakyReLU
    each; the first without BN), then ``fc1``, ``fc2``."""
    names = ["tower.0"]
    for i in range(7):
        names += [f"tower.{2 + 3 * i}", f"tower.{3 + 3 * i}"]
    return names + ["fc1", "fc2"]


# ---------------------------------------------------------------------------
# atoms ↔ state dict
# ---------------------------------------------------------------------------


def _atoms(model_name: str, model: nn.Module) -> list[tuple]:
    """``(reference name, flax path, kind[, extra])`` of every atom."""
    if model_name.lower() == "discriminator":
        hr = model.Dense_0.in_features // (
            model.ConvBlock_7.Conv_0.out_channels)
        plan = discriminator_plan(math.isqrt(hr) * 16,
                                  model.ConvBlock_0.Conv_0.out_channels)
        names = discriminator_names()
    else:
        plan = reference_plan(model_name, model)
        names = reference_names(model_name, model)
    if len(plan) != len(names):
        raise AssertionError(f"{model_name}: {len(plan)} atoms planned, "
                             f"{len(names)} named")
    return [(name, *entry) for name, entry in zip(names, plan)]


def _resolve(model: nn.Module, path: str):
    """The port module (or bare parameter) at a flax path."""
    mods = {"/".join(flax_path(n)): m for n, m in model.named_modules() if n}
    if path in mods:
        return mods[path]
    parent, _, leaf = path.rpartition("/")
    owner = mods[parent] if parent else model
    return getattr(owner, leaf)


def _tensors(kind: str, mod, extra) -> OrderedDict:
    """An atom's reference tensors from the port module, in the reference
    module's own order, float32 on the CPU."""
    out: OrderedDict = OrderedDict()

    def put(field, t):
        out[field] = t.detach().to("cpu", torch.float32).contiguous().clone()

    if kind in ("conv", "deconv", "dense"):
        put("weight", mod.weight)
        if mod.bias is not None:
            put("bias", mod.bias)
    elif kind == "dense_nhwc":
        h, w, c = extra
        wt = mod.weight.reshape(mod.out_features, h, w, c).permute(0, 3, 1, 2)
        put("weight", wt.reshape(mod.out_features, c * h * w))
        put("bias", mod.bias)
    elif kind == "bn":
        put("weight", mod.scale)
        put("bias", mod.bias)
        put("running_mean", mod.mean)
        put("running_var", mod.var)
        out["num_batches_tracked"] = torch.tensor(0, dtype=torch.long)
    elif kind == "prelu":
        put("weight", mod.slope.reshape(1))
    elif kind == "tensor":
        put("", mod)
    else:
        raise ValueError(f"unknown atom kind {kind!r}")
    return out


def reference_state_dict(model_name: str, model: nn.Module) -> OrderedDict:
    """A port model's weights as the reference ``Net``'s state dict: its
    key names, its order, float32 CPU tensors. ``model_name`` is a zoo
    model's name, or ``"discriminator"`` for SRGAN's discriminator."""
    sd: OrderedDict = OrderedDict()
    for name, path, kind, *extra in _atoms(model_name, model):
        mod = _resolve(model, path)
        for field, t in _tensors(kind, mod, extra[0] if extra else None
                                 ).items():
            sd[f"{name}.{field}" if field else name] = t
    return sd


def _group(state_dict) -> list[tuple[str, dict]]:
    """A state dict as ``[(prefix, {field: tensor})]`` in its order, the
    ``num_batches_tracked`` buffers dropped; a bare parameter (no dot in its
    key) is a group of one field ``""``."""
    groups: OrderedDict = OrderedDict()
    for k, v in state_dict.items():
        if k.endswith("num_batches_tracked"):
            continue
        prefix, _, field = k.rpartition(".")
        if prefix == "":
            prefix, field = k, ""
        groups.setdefault(prefix, {})[field] = torch.as_tensor(v)
    return list(groups.items())


def load_reference_state_dict(model_name: str, model: nn.Module,
                              state_dict) -> nn.Module:
    """Load a reference state dict into the port ``model`` in place and
    return it. Pairs atoms positionally; raises ``ValueError`` naming the
    atom when the counts or a shape do not fit. A conv whose checkpoint
    atom has no bias gets a zero bias (a torch ``bias=False`` layer)."""
    atoms = _atoms(model_name, model)
    groups = _group(state_dict)
    if len(groups) != len(atoms):
        raise ValueError(
            f"checkpoint has {len(groups)} atoms "
            f"({[p for p, _ in groups[:6]]}…), the {model_name} plan "
            f"expects {len(atoms)}")
    with torch.no_grad():
        for (name, path, kind, *extra), (prefix, g) in zip(atoms, groups):
            mod = _resolve(model, path)
            want = _tensors(kind, mod, extra[0] if extra else None)
            want.pop("num_batches_tracked", None)
            for field, target in want.items():
                if field == "bias" and field not in g and kind in (
                        "conv", "deconv"):
                    g[field] = torch.zeros_like(target)
                if field not in g:
                    raise ValueError(f"checkpoint atom {prefix!r} lacks "
                                     f"{field!r} for {path} ({kind})")
                if g[field].shape != target.shape:
                    raise ValueError(
                        f"checkpoint atom {prefix!r} {field} "
                        f"{tuple(g[field].shape)} does not fit {path} "
                        f"({kind}) {tuple(target.shape)}")
            extra_fields = set(g) - set(want)
            if extra_fields:
                raise ValueError(f"checkpoint atom {prefix!r} has "
                                 f"{sorted(extra_fields)} that {path} "
                                 f"({kind}) has no place for")
            _store(kind, mod, g, extra[0] if extra else None)
    for m in model.modules():
        if hasattr(m, "packed"):
            m.packed()
    return model


def _store(kind: str, mod, g: dict, extra) -> None:
    def cp(dst, src):
        dst.copy_(src.reshape(dst.shape).to(dst.dtype))

    if kind in ("conv", "deconv", "dense"):
        cp(mod.weight, g["weight"])
        if mod.bias is not None:
            cp(mod.bias, g["bias"])
    elif kind == "dense_nhwc":
        h, w, c = extra
        wt = g["weight"].reshape(mod.out_features, c, h, w).permute(0, 2, 3, 1)
        cp(mod.weight, wt.reshape(mod.out_features, h * w * c))
        cp(mod.bias, g["bias"])
    elif kind == "bn":
        cp(mod.scale, g["weight"])
        cp(mod.bias, g["bias"])
        cp(mod.mean, g["running_mean"])
        cp(mod.var, g["running_var"])
    elif kind == "prelu":
        cp(mod.slope, g["weight"])
    else:  # tensor
        cp(mod, g[""])


def load_reference_checkpoint(model_name: str, model: nn.Module,
                              path: str) -> nn.Module:
    """Load a reference ``<Model>_param.pkl`` (``torch.save(state_dict)``)
    into the port ``model``; see :func:`load_reference_state_dict`."""
    state_dict = torch.load(path, map_location="cpu", weights_only=True)
    return load_reference_state_dict(model_name, model, state_dict)


def export_reference_checkpoint(model_name: str, model: nn.Module,
                                path: str) -> str:
    """Write a port model as a reference ``<Model>_param.pkl``, so a model
    trained here loads in the reference collection. Returns ``path``."""
    torch.save(reference_state_dict(model_name, model), path)
    return path
