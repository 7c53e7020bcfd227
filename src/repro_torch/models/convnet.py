"""Small VGG/MobileNet-style conv nets for the paper's CONV-layer path
(§4.1.2 block-punched and §2.1.1 pattern/connectivity pruning, CIFAR-10
shaped inputs).  Weight layout (out_ch, in_ch, kh, kw) = the paper's
(P, Q, Kh, Kw); activations are NHWC, as in the reference.

``serve.compile.compile_model`` installs a layout next to each pruned conv
(``params[name]["packed"]``): a ``PackedLayout`` of the im2col-lowered
weight for block-punched layers, a ``TapLayout`` for pattern/connectivity
layers.  ``convnet_apply`` dispatches on the layout type to
``kernels.ops.sparse_conv2d`` / ``sparse_conv2d_pattern`` (bias + relu
fused in the kernel epilogue).  Unpacked and depthwise layers run a
masked-dense ``F.conv2d`` (work the reference leaves to XLA)."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.core.packed import DegradedLayer, TapLayout
from repro_torch.kernels import ops
from repro_torch.kernels.bsr_matmul import pad_image
from repro_torch.models import module as M

# (name, out_ch, kh, kw, stride, depthwise)
VGG_TINY = [
    ("c1", 32, 3, 3, 1, False),
    ("c2", 64, 3, 3, 2, False),
    ("c3", 64, 3, 3, 1, False),
    ("c4", 128, 3, 3, 2, False),
    ("c5", 128, 1, 1, 1, False),
    ("c6", 128, 3, 3, 1, False),
]

MOBILE_TINY = [
    ("c1", 32, 3, 3, 1, False),
    ("dw2", 32, 3, 3, 1, True),
    ("pw2", 64, 1, 1, 1, False),
    ("dw3", 64, 3, 3, 2, True),
    ("pw3", 128, 1, 1, 1, False),
    ("c4", 128, 5, 5, 1, False),   # a non-3x3 kernel, per the paper's point
]


def _conv_init(shape, gen, dtype, dev, scale):
    """Truncated normal on [-2, 2] times ``scale``, drawn in one call (a
    conv weight is small; ``module.dense_init`` draws slice by slice)."""
    t = torch.empty(shape, dtype=torch.float32, device=dev)
    torch.nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=gen)
    return (t * scale).to(dtype)


def convnet_init(arch=VGG_TINY, seed=0, in_ch=3, n_classes=10,
                 dtype=torch.float32, device="cuda"):
    """Seeded params: fan-in-scaled truncated normals for every conv and
    the ``fc`` head, zero biases, drawn from one ``torch.Generator`` in
    arch order."""
    dev = M.resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    params = {}
    c = in_ch
    for (name, out, kh, kw, stride, dw) in arch:
        if dw:
            w = _conv_init((c, 1, kh, kw), gen, dtype, dev,
                           (kh * kw) ** -0.5)
        else:
            w = _conv_init((out, c, kh, kw), gen, dtype, dev,
                           (c * kh * kw) ** -0.5)
            c = out
        params[name] = {"w": w,
                        "b": torch.zeros((c,), dtype=dtype, device=dev)}
    params["fc"] = {"w": M.dense_init((c, n_classes), gen, dtype, dev),
                    "b": torch.zeros((n_classes,), dtype=dtype, device=dev)}
    return params


def _dense_conv(x, w, stride, groups=1):
    """NHWC conv with XLA's SAME padding (asymmetric at an even input and
    stride 2, so the halo is an explicit ``F.pad``)."""
    xp, _ = pad_image(x, w.shape[-2], w.shape[-1], stride)
    return F.conv2d(xp.permute(0, 3, 1, 2), w, stride=stride,
                    groups=groups).permute(0, 2, 3, 1)


def convnet_apply(params, x, arch=VGG_TINY, masks=None, implicit=None):
    """x (B, H, W, Cin) -> logits (B, n_classes).  ``implicit`` routes
    packed conv layers through the implicit kernels (None = per-layer
    auto by patch size, True / False force one mode).  A layer whose
    layout was retired (``DegradedLayer``) runs the dense conv on its
    retained ``w``."""
    m = masks or {}
    for (name, out, kh, kw, stride, dw) in arch:
        p = params[name]
        packed = p.get("packed")
        if isinstance(packed, DegradedLayer):
            packed = None                # retired: masked-dense on w
        if packed is not None and not dw:
            conv = (ops.sparse_conv2d_pattern if isinstance(packed, TapLayout)
                    else ops.sparse_conv2d)
            x = conv(x, packed, kh=kh, kw=kw, stride=stride, bias=p["b"],
                     act="relu", implicit=implicit)
            continue
        w = p["w"]
        mk = m.get(name)
        if mk is not None and mk.ndim:
            w = w * mk.to(w.dtype)
        y = _dense_conv(x, w, stride, groups=x.shape[-1] if dw else 1)
        x = torch.clamp_min(y + p["b"], 0)
    x = torch.mean(x, dim=(1, 2))                 # global average pool
    return torch.matmul(x, params["fc"]["w"]) + params["fc"]["b"]


def synthetic_images(generator, batch, n_classes=10, size=16, hard=False):
    """CIFAR-like synthetic classification on ``generator``'s device:
    (images (B, size, size, 3) fp32, labels (B,) int64).  ``hard=False``:
    the class sets a 3-channel color mixture; ``hard=True``: the class
    sets the spatial texture frequency (see the reference)."""
    dev = generator.device
    labels = torch.randint(0, n_classes, (batch,), generator=generator,
                           device=dev)
    grid = torch.arange(size, dtype=torch.float32, device=dev) / size
    yy, xx = grid[:, None].expand(size, size), grid[None, :].expand(size,
                                                                    size)
    if hard:
        freq = 1.0 + labels.float() * 0.5
        tex = torch.sin(2 * torch.pi * freq[:, None, None] * xx[None]) * \
            torch.sin(2 * torch.pi * freq[:, None, None] * yy[None])
        img = tex[..., None].expand(-1, -1, -1, 3)
    else:
        angles = labels.float() / n_classes * 2 * torch.pi
        mix = torch.stack([torch.cos(angles), torch.sin(angles),
                           torch.cos(2 * angles)], dim=-1)      # (B, 3)
        smooth = 0.5 + 0.5 * torch.sin(2 * torch.pi * (xx + yy))[None]
        img = mix[:, None, None, :] * smooth[..., None]
    noise = torch.randn(img.shape, generator=generator, device=dev) * 0.3
    return (img + noise).float(), labels


def classify_loss(params, batch, arch=VGG_TINY, masks=None):
    """Mean cross-entropy of ``convnet_apply``'s logits on (images,
    labels)."""
    logp = torch.log_softmax(convnet_apply(params, batch[0], arch, masks),
                             dim=-1)
    return -torch.mean(torch.gather(logp, 1, batch[1][:, None].long()))


def accuracy(params, batch, arch=VGG_TINY, masks=None):
    """Top-1 accuracy of ``convnet_apply`` on (images, labels)."""
    logits = convnet_apply(params, batch[0], arch, masks)
    return torch.mean((torch.argmax(logits, -1) == batch[1]).float())
