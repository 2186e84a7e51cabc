"""Spec-driven Darknet/YOLOv3: eval-mode inference on BN-folded weights,
and training with live batch norm (counterpart of the JAX package's
``models/darknet.py``).

The graph comes from the port's frozen ``NetworkSpec``
(``config/darknet_cfg.py``, a copy of the JAX package's parser). Parameter
trees mirror the JAX package's with OIHW weights: ``{"<block index>":
{"w", "bn": {"scale", "bias"}}}`` for BN convs and ``{"w", "b"}`` for the
linear pre-yolo convs, plus a state tree of BN running ``{"mean",
"var"}``. :func:`init_params` makes them, :class:`TrainDarknet` trains
them, :func:`fold_bn` folds them and :class:`Darknet` runs the folded
graph. Both can run blocks 0-1 as the packed space-to-depth stem
(``models/stem_opt.py``): ``Darknet(packed_stem=)`` on its folded packed
weights, ``TrainDarknet.forward_features(packed_stem=True)`` on packed
weights rebuilt from the canonical ones every forward, with its batch
norm taking the statistics of the four parity planes as one. Frames,
activations and head outputs are NHWC; each convolution views its input
as NCHW (channels_last). :func:`load_darknet_weights` and
:func:`save_darknet_weights` read and write such trees as Darknet
``.weights`` files (local paths).

Several devices (``parallel/mesh.py``): a :class:`TrainDarknet` built on
:func:`~..parallel.mesh.shard_channels`' part of a tree under a ``model``
sub-mesh holds only its block of each split convolution's out-channels
(tensor parallel), and ``detections(x, spatial=model mesh)`` runs the eval
forward on this rank's frame rows with halo exchanges (spatial).
"""

from __future__ import annotations

import functools
import itertools
from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from mit_driverless_cv_traininginfra_tpu_torch.config.darknet_cfg import (
    ConvBlock,
    MaxPoolBlock,
    NetworkSpec,
    RouteBlock,
    ShortcutBlock,
    UpsampleBlock,
    YoloBlock,
)
from mit_driverless_cv_traininginfra_tpu_torch.models.rektnet import (
    _BN,
    BN_EPS,
    conv2d,
)
from mit_driverless_cv_traininginfra_tpu_torch.models.stem_opt import (
    apply_packed_stem,
    pack_input,
    pack_stem_weights,
    pad_packed,
    stem_is_packable,
)
from mit_driverless_cv_traininginfra_tpu_torch.parallel.mesh import (
    copy_to_model,
    gather_blocks,
    halo_exchange,
    spatial_rows,
)


def init_params(spec: NetworkSpec, gen: torch.Generator):
    """``(params, state)`` trees of ``spec``, f32 on the CPU (the JAX
    package's ``init_params``): He-normal OIHW conv weights, std
    sqrt(2 / (k·k·cin)), drawn from ``gen`` one conv block after the other
    (``torch.Generator`` draws other numbers than ``jax.random``); BN scale
    1, bias 0, running mean 0, var 1; a zero ``b`` for the linear pre-yolo
    convs. Keys are the blocks' indices as strings."""
    params, state = {}, {}
    chans = spec.out_channels
    for i, b in enumerate(spec.blocks):
        if not isinstance(b, ConvBlock):
            continue
        std = (2.0 / (b.size * b.size * chans[i])) ** 0.5
        p = {"w": torch.randn((b.filters, chans[i], b.size, b.size),
                              generator=gen) * std}
        if b.batch_normalize:
            p["bn"] = {"scale": torch.ones(b.filters),
                       "bias": torch.zeros(b.filters)}
            state[str(i)] = {"mean": torch.zeros(b.filters),
                             "var": torch.ones(b.filters)}
        else:
            p["b"] = torch.zeros(b.filters)
        params[str(i)] = p
    return params, state


def fold_bn(params, state, spec: NetworkSpec):
    """Fold BN into conv weight/bias: w' = w·γ/σ, b' = β − μ·γ/σ. Returns
    ``{"<i>": {"w", "b"}}`` for every conv block."""
    folded = {}
    for i, b in enumerate(spec.blocks):
        if not isinstance(b, ConvBlock):
            continue
        p = params[str(i)]
        if b.batch_normalize:
            s = state[str(i)]
            inv = p["bn"]["scale"] / torch.sqrt(s["var"] + BN_EPS)
            folded[str(i)] = {"w": p["w"] * inv[:, None, None, None],
                              "b": p["bn"]["bias"] - s["mean"] * inv}
        else:
            folded[str(i)] = {"w": p["w"], "b": p["b"]}
    return folded


def load_darknet_weights(spec: NetworkSpec, params, state, weights_path: str,
                         start_weights_dim: Optional[Sequence[int]] = None):
    """Read a Darknet ``.weights`` file into ``(params, state)`` trees of
    ``spec`` (OIHW, as :func:`fold_bn` takes them; the given trees give
    each conv's input width and are not changed). Returns ``(params,
    state, header)``.

    Per conv block, in file order: BN ``bias, scale, mean, var`` then the
    OIHW weight; a pre-yolo conv: its bias, then its weight, where
    ``start_weights_dim`` (default ``spec.net.start_weights_dim``) names
    the filter count stored in the file for each head in turn, of which
    the first ``filters`` are taken (an 80-class head warm-starts a
    1-class one)."""
    if start_weights_dim is None:
        start_weights_dim = spec.net.start_weights_dim
    with open(weights_path, "rb") as fp:
        header = np.fromfile(fp, dtype=np.int32, count=5)
        weights = np.fromfile(fp, dtype=np.float32)

    ptr = 0

    def take(shape, keep: Optional[int] = None):
        """The next values of the file as an f32 tensor of ``shape``, cut
        to its first ``keep`` rows."""
        nonlocal ptr
        n = int(np.prod(shape))
        a = weights[ptr:ptr + n]
        if a.size != n:
            raise ValueError(f"{weights_path} ends after {weights.size} "
                             "values, before every conv block is read")
        ptr += n
        return torch.from_numpy(a.reshape(shape)[:keep].copy()).to(dev)

    params, state = dict(params), dict(state)
    heads = 0
    for i, b in enumerate(spec.blocks):
        if not isinstance(b, ConvBlock):
            continue
        p = dict(params[str(i)])
        cout, k, cin = b.filters, b.size, p["w"].shape[1]
        dev = p["w"].device
        if b.batch_normalize:
            p["bn"] = {"bias": take((cout,)), "scale": take((cout,))}
            state[str(i)] = {"mean": take((cout,)), "var": take((cout,))}
            p["w"] = take((cout, cin, k, k))
        else:
            stored = start_weights_dim[heads] if start_weights_dim else cout
            heads += 1
            p["b"] = take((stored,), cout)
            p["w"] = take((stored, cin, k, k), cout)
        params[str(i)] = p
    return params, state, header


def save_darknet_weights(spec: NetworkSpec, params, state, path: str,
                         header=None, cutoff: int = -1):
    """Write ``(params, state)`` (OIHW trees) as a Darknet ``.weights``
    file in :func:`load_darknet_weights`' order, f32. ``cutoff`` is a
    literal slice end over the blocks: the reference's default ``-1``
    never writes the last block, which is a weightless yolo block in every
    real cfg."""
    if header is None:
        header = np.zeros(5, dtype=np.int32)
    with open(path, "wb") as fp:
        np.asarray(header, dtype=np.int32).tofile(fp)
        for i, b in enumerate(spec.blocks[:cutoff]):
            if not isinstance(b, ConvBlock):
                continue
            p = params[str(i)]
            arrays = ([p["bn"]["bias"], p["bn"]["scale"], state[str(i)]["mean"],
                       state[str(i)]["var"]] if b.batch_normalize else [p["b"]])
            for a in arrays + [p["w"]]:
                a.detach().float().cpu().numpy().tofile(fp)


def _maxpool(x, size: int, stride: int):
    """torch MaxPool2d semantics incl. the reference's k=2, s=1 case, which
    zero-pads one row and column at the bottom/right first."""
    if size == 2 and stride == 1:
        return F.max_pool2d(F.pad(x, (0, 1, 0, 1)), 2, 1)
    return F.max_pool2d(x, size, stride, (size - 1) // 2)


def _maxpool_nhwc(x, size: int, stride: int):
    return _maxpool(x.permute(0, 3, 1, 2), size, stride).permute(0, 2, 3, 1)


def _halo_rows(size: int, stride: int, pad: int) -> tuple:
    """Rows a window of ``size`` at ``stride`` with ``pad`` rows of padding
    above reads from the previous block and the next one, when each block
    of input rows is a multiple of the stride."""
    return pad, max(size - stride - pad, 0)


def _spatial_maxpool(x, size: int, stride: int, mesh):
    """:func:`_maxpool` on this rank's rows of NHWC ``x``: the reference's
    k=2, s=1 pool takes the next rank's first row where :func:`_maxpool`
    pads a zero row (the last rank pads it); any other pool takes its
    halo rows, −inf at the frame's edges as ``max_pool2d`` pads."""
    if size == 2 and stride == 1:
        x = halo_exchange(x, mesh, 1, 0, 1, 0.0).permute(0, 3, 1, 2)
        y = F.max_pool2d(F.pad(x, (0, 1)), 2, 1)
    else:
        pad = (size - 1) // 2
        x = halo_exchange(x, mesh, 1, *_halo_rows(size, stride, pad), float("-inf"))
        y = F.max_pool2d(x.permute(0, 3, 1, 2), size, stride, (0, pad))
    return y.permute(0, 2, 3, 1)


def block_strides(spec: NetworkSpec) -> list:
    """Each block's output stride: frame rows a row of its output."""
    strides = []
    for b in spec.blocks:
        s = strides[-1] if strides else 1
        if isinstance(b, (ConvBlock, MaxPoolBlock)):
            s *= b.stride
        elif isinstance(b, UpsampleBlock):
            s //= b.stride
        elif isinstance(b, RouteBlock):
            s = strides[b.layers[0]]
        strides.append(s)
    return strides


def coarsest_stride(spec: NetworkSpec) -> int:
    """The largest block stride: 32 for YOLOv3, whose coarsest head it is.
    The spatial split hands out frame rows in whole rows of it, so that
    every level splits cleanly."""
    return max(block_strides(spec))


@functools.cache
def _slope_in(slope: float, dtype) -> float:
    """``slope`` rounded to ``dtype`` (bf16: 0.1 → 0.10009765625)."""
    return float(torch.tensor(slope, dtype=dtype))


def _leaky(x, slope: float):
    """The JAX package's ``_leaky``, ``where(x >= 0, x, x * slope)``, where
    a weak Python float meets the tensor: the slope is rounded to
    ``x.dtype`` first and the product is rounded once. ``F.leaky_relu(x,
    0.1)`` multiplies bf16 by the f32 0.1 and lands one bf16 ulp off on
    ~10% of negative values; given the rounded slope it rounds as JAX."""
    return F.leaky_relu(x, _slope_in(slope, x.dtype))


def _upsample(x, stride: int):
    """Nearest-neighbour ×stride on NHWC."""
    return x.repeat_interleave(stride, dim=1).repeat_interleave(stride, dim=2)


def head_predictions(head_out, num_anchors: int, num_classes: int):
    """The training branch's views of a head (B, H, W, A·(5+C)) NHWC:
    ``x``, ``y``, ``conf``, ``cls`` through the sigmoid, ``w``, ``h`` and
    the raw ``conf_logit`` (the loss takes its BCE from logits), each
    (B, A, H, W[, C])."""
    b, gh, gw, _ = head_out.shape
    pred = head_out.reshape(b, gh, gw, num_anchors, 5 + num_classes
                            ).permute(0, 3, 1, 2, 4)
    return {"x": torch.sigmoid(pred[..., 0]), "y": torch.sigmoid(pred[..., 1]),
            "w": pred[..., 2], "h": pred[..., 3],
            "conf": torch.sigmoid(pred[..., 4]), "conf_logit": pred[..., 4],
            "cls": torch.sigmoid(pred[..., 5:])}


def decode_head(head_out, anchors: Sequence[Tuple[float, float]],
                img_height: int, num_classes: int,
                with_classes: bool = True):
    """YOLO anchor decode, eval branch: head_out (B, H, W, A·(5+C)) NHWC →
    (B, A·H·W, 5+C) — or 5 columns with ``with_classes=False`` — as
    [cx, cy, w, h] in input pixels, conf, cls. Decodes in f32 whatever the
    head dtype (box centres reach 416, where bf16's ulp is 2) and uses the
    height stride on both axes (the reference's quirk). ``anchors`` (A, 2)
    (w, h) pairs; pass them as an f32 tensor on the head's device to keep
    the host from waiting on a host→device copy."""
    b, gh, gw, _ = head_out.shape
    na = len(anchors)
    nattr = 5 + num_classes
    stride = img_height / gh
    pred = head_out.float().reshape(b, gh, gw, na, nattr).permute(0, 3, 1, 2, 4)
    xy = torch.sigmoid(pred[..., 0:2])
    wh = pred[..., 2:4]
    conf = torch.sigmoid(pred[..., 4:5])
    dev = head_out.device
    grid_x = torch.arange(gw, dtype=torch.float32, device=dev)[None, None, None, :]
    grid_y = torch.arange(gh, dtype=torch.float32, device=dev)[None, None, :, None]
    anc = torch.as_tensor(anchors, dtype=torch.float32, device=dev) / stride
    aw = anc[:, 0][None, :, None, None]
    ah = anc[:, 1][None, :, None, None]
    boxes = torch.stack([xy[..., 0] + grid_x, xy[..., 1] + grid_y,
                         torch.exp(wh[..., 0]) * aw,
                         torch.exp(wh[..., 1]) * ah], dim=-1)
    cols = [boxes * stride, conf]
    if with_classes:
        cols.append(torch.sigmoid(pred[..., 5:]))
    out = torch.cat(cols, dim=-1)
    return out.reshape(b, na * gh * gw, out.shape[-1])


class YoloHeads(nn.Module):
    """What every detector of a spec shares: the walk over its blocks on
    NHWC activations and the f32 anchor decode of its yolo heads. A
    subclass supplies each conv block's step (:meth:`_conv`) and the dtype
    it takes frames in (``frame_dtype``); it may run the first blocks
    itself (:meth:`_enter`)."""

    frame_dtype: torch.dtype

    def __init__(self, spec: NetworkSpec):
        super().__init__()
        self.spec = spec
        self._yolo = [b for b in spec.blocks if isinstance(b, YoloBlock)]
        # f32 anchors per device, kept off the module's buffers so that
        # .to(torch.bfloat16) cannot round them
        self._anchors: dict[torch.device, list[torch.Tensor]] = {}

    @property
    def device(self) -> torch.device:
        return next(itertools.chain(self.parameters(), self.buffers())).device

    def _anchor_tensors(self, device):
        if device not in self._anchors:
            self._anchors[device] = [
                torch.tensor(yb.anchors, dtype=torch.float32, device=device)
                for yb in self._yolo]
        return self._anchors[device]

    def _enter(self, x):
        """Frames (B, H, W, C) → (activation, outputs of the blocks run so
        far); the walk goes on from block ``len(outputs)``."""
        return x, []

    def _conv(self, i: int, x):
        """Conv block ``i`` on NHWC ``x``, before its activation."""
        raise NotImplementedError

    def forward_features(self, x):
        """x (B, H, W, C) → raw pre-yolo maps, one per yolo head, each
        NHWC (B, h, w, A·(5+C))."""
        return self._walk(x, len(self.spec.blocks))[1]

    def truncated_forward(self, x, stop: int):
        """The walk cut after block ``stop`` (inclusive): that block's NHWC
        output, e.g. the input of a residual stage (the JAX package's
        ``tools/profile_detect.py:truncated_forward``)."""
        x, _ = self._walk(x, stop + 1)
        return x

    def _walk(self, x, end: int, conv=None, pool=_maxpool_nhwc, enter=None):
        """Blocks up to ``end`` (exclusive) → (last activation, pre-yolo
        maps met so far). ``conv(i, x)`` runs conv block ``i`` (default
        :meth:`_conv`), ``pool(x, size, stride)`` a maxpool block,
        ``enter(x)`` the first blocks (default :meth:`_enter`)."""
        conv = conv or self._conv
        slope = self.spec.net.leaky_slope
        x, layer_outputs = (enter or self._enter)(x)
        if end < len(layer_outputs):
            raise ValueError(f"the walk starts after block "
                             f"{len(layer_outputs) - 1}; cannot stop at "
                             f"block {end - 1}")
        outputs = []
        for i in range(len(layer_outputs), end):
            b = self.spec.blocks[i]
            if isinstance(b, ConvBlock):
                x = conv(i, x)
                if b.activation == "leaky":
                    x = _leaky(x, slope)
                elif b.activation == "ReLU":
                    x = F.relu(x)
            elif isinstance(b, MaxPoolBlock):
                x = pool(x, b.size, b.stride)
            elif isinstance(b, UpsampleBlock):
                x = _upsample(x, b.stride)
            elif isinstance(b, RouteBlock):
                x = torch.cat([layer_outputs[li] for li in b.layers], dim=-1)
            elif isinstance(b, ShortcutBlock):
                x = layer_outputs[-1] + layer_outputs[b.from_layer]
            elif isinstance(b, YoloBlock):
                outputs.append(x)
            layer_outputs.append(x)
        return x, outputs

    def detections(self, x, with_classes: bool = True, **kw):
        """Full eval forward: per-head decodes concatenated along the box
        axis, (B, ΣA·h·w, 5+C) (or 5 with ``with_classes=False``), f32.
        ``kw`` goes to :meth:`forward_features`."""
        anchors = self._anchor_tensors(x.device)
        return torch.cat([
            decode_head(h, anc, self.spec.net.height,
                        self.spec.net.num_classes, with_classes=with_classes)
            for h, anc in zip(self.forward_features(x, **kw), anchors)
        ], dim=1)

    def forward(self, x):
        """The serving decode: ``detections(x, with_classes=False)``."""
        return self.detections(x, with_classes=False)


class _PackedStem(nn.Module):
    """:func:`~.stem_opt.build_packed_stem`'s tree held as buffers, so
    that ``.to()`` casts and moves it with the model."""

    def __init__(self, packed):
        super().__init__()
        for k in ("w1", "b1", "w2", "b2"):
            self.register_buffer(k, packed[k].detach().clone())

    def forward(self, x, slope: float):
        return apply_packed_stem(dict(self.named_buffers()), x, slope)


class Darknet(YoloHeads):
    """Eval-mode Darknet on a :func:`fold_bn` tree of ``spec``. It takes
    frames in its weights' dtype (``frame_dtype``).

    ``packed_stem`` (:func:`~.stem_opt.build_packed_stem` of the same
    tree) runs blocks 0-1 as the packed space-to-depth stem; their plain
    convs are then not built. Blocks 0-1 are never routed to in a
    packable spec, so block 1's output fills both slots of the walk."""

    def __init__(self, spec: NetworkSpec, folded, packed_stem=None):
        super().__init__(spec)
        self.stem = None
        start = 0
        if packed_stem is not None:
            if not stem_is_packable(spec):
                raise ValueError("packed_stem given, but blocks 0-1 of this spec "
                                 "are not a 3×3 s1 and a 3×3 s2 conv on an even input")
            self.stem = _PackedStem(packed_stem)
            start = 2
        self.convs = nn.ModuleDict({
            str(i): conv2d(folded[str(i)]["w"], folded[str(i)]["b"],
                           stride=b.stride, padding=(b.size - 1) // 2)
            for i, b in list(enumerate(spec.blocks))[start:]
            if isinstance(b, ConvBlock)
        })

    @property
    def frame_dtype(self) -> torch.dtype:
        return next(iter(self.convs.values())).weight.dtype

    def _enter(self, x):
        if self.stem is None:
            return x, []
        x = self.stem(x, self.spec.net.leaky_slope)
        return x, [x, x]

    def _conv(self, i: int, x):
        return self.convs[str(i)](x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)


class _TrainConv(nn.Module):
    """A conv block's f32 master ``weight`` (OIHW) and either a batch norm
    (``bn``: its ``weight``/``bias`` parameters and running stats) or the
    linear pre-yolo conv's ``bias``.

    Given a block of ``filters`` out-channels (a ``model_mesh`` position's
    part of a tree :func:`~..parallel.mesh.shard_channels` split), it holds
    that block only, its parameters marked ``model_split``: the input goes
    through :func:`copy_to_model`, and the block's output, normalised, is
    gathered over the ``model`` mesh into all ``filters`` channels."""

    def __init__(self, p, s, stride: int, padding: int, filters: int,
                 model_mesh=None):
        super().__init__()
        self.stride, self.padding = stride, padding
        self.weight = nn.Parameter(p["w"].detach().clone().float())
        if "bn" in p:
            self.bn = _BN(p["bn"], s)
            leaves = [p["bn"]["scale"], p["bn"]["bias"], s["mean"], s["var"]]
        else:
            self.bias = nn.Parameter(p["b"].detach().clone().float())
            leaves = [p["b"]]
        out = self.weight.shape[0]
        if any(v.shape[-1] != out for v in leaves):
            raise ValueError("a conv block's leaves split together: weight "
                             f"{tuple(self.weight.shape)}, vectors "
                             f"{[tuple(v.shape) for v in leaves]}")
        self.split = None
        if out != filters:
            if model_mesh is None or out * model_mesh.size != filters:
                raise ValueError(f"{out} of {filters} out-channels, model mesh "
                                 f"{model_mesh}")
            self.split = model_mesh
            for t in self.parameters():
                t.model_split = True

    def forward(self, x, dtype, train: bool, mesh=None, padding=None):
        """NCHW ``x`` → the conv (parameters cast to ``dtype``; ``padding``
        overrides the block's), then the batch norm (batch statistics, the
        global batch's under a process ``mesh``, and a running-stat update
        in training) or ``+ b``, each rounded to ``dtype`` as the JAX
        package rounds."""
        if self.split is not None:
            x = copy_to_model(x, self.split)
        y = F.conv2d(x, self.weight.to(dtype), None, self.stride,
                     self.padding if padding is None else padding)
        if hasattr(self, "bn"):
            y = self.bn(y, dtype, train, mesh)
        else:
            y = y + self.bias.to(dtype)[None, :, None, None]
        if self.split is not None:
            y = gather_blocks(y, self.split, 1)
        return y


class TrainDarknet(YoloHeads):
    """Trainable Darknet on ``(params, state)`` trees of ``spec`` (the JAX
    package's ``forward_features`` on unfolded parameters): f32 master
    parameters and the BN running stats as buffers, a :class:`_TrainConv`
    per conv block under ``convs["<i>"]``.

    ``forward_features(x, train, dtype)`` casts the parameters and the
    frames to ``dtype`` (f32 or bf16, as the JAX step casts its parameter
    tree; not ``torch.autocast``); in training, batch norm takes batch
    statistics in f32 and updates the running stats in place.
    ``detections(x)`` is the eval forward in f32 on the running stats,
    unfolded (folding moves the rounding). :meth:`folded` gives the tree
    the serving :class:`Darknet` takes.

    Tensor parallel: under a ``model_mesh`` (a 2-D mesh's ``model``
    sub-mesh) ``params`` and ``state`` are this position's
    :func:`~..parallel.mesh.shard_channels` part, and each split block
    holds its out-channels only (:class:`_TrainConv`); the rest runs whole
    on every rank with no collective. :meth:`trees` then gives the parts,
    which :func:`~..parallel.mesh.gather_channels` joins.

    Spatial: ``forward_features(x, spatial=model mesh)`` (and so
    ``detections``) runs the eval forward on this rank's frame rows (the
    part :func:`~..parallel.mesh.shard_spatial` gives it), with whole
    weights.

    Packed stem: ``forward_features(x, packed_stem=True)`` runs blocks 0-1
    as the space-to-depth stem (the JAX package's ``train_packed_stem``;
    the spec must be ``stem_is_packable``). Neither tensor parallel nor
    the spatial forward takes it, as in the JAX package."""

    frame_dtype = torch.float32

    def __init__(self, spec: NetworkSpec, params, state, model_mesh=None):
        super().__init__(spec)
        self.convs = nn.ModuleDict({
            str(i): _TrainConv(params[str(i)], state.get(str(i)), b.stride,
                               (b.size - 1) // 2, b.filters, model_mesh)
            for i, b in enumerate(spec.blocks) if isinstance(b, ConvBlock)})

    def _conv(self, i: int, x, train: bool = False, dtype=torch.float32,
              mesh=None):
        y = self.convs[str(i)](x.permute(0, 3, 1, 2), dtype, train, mesh)
        return y.permute(0, 2, 3, 1)

    def forward_features(self, x, train: bool = False, dtype=torch.float32,
                         mesh=None, spatial=None, packed_stem: bool = False):
        """x (B, H, W, C) → the raw pre-yolo maps in ``dtype``, one per
        yolo head, each NHWC (B, h, w, A·(5+C)). Under a process ``mesh``
        the training batch norms take the global batch's statistics.
        ``packed_stem``: blocks 0-1 run as the space-to-depth stem
        (:meth:`_packed_stem`).

        ``spatial``: a ``model`` mesh over which the frame rows are split
        (:func:`~..parallel.mesh.spatial_rows`); ``x`` is this rank's rows.
        Each conv and pool takes its halo rows from its neighbours, the
        rest stays local, and the maps are gathered on H in rank order, so
        every rank returns the whole maps of its batch rows."""
        enter = None
        if packed_stem:
            if spatial is not None or any(c.split is not None
                                          for c in self.convs.values()):
                raise ValueError("the packed stem runs on whole weights and whole "
                                 "frames: not with tensor parallel (model_mesh) or "
                                 "the spatial forward")
            if not stem_is_packable(self.spec):
                raise ValueError("packed_stem needs blocks 0-1 to be a 3×3 s1 and "
                                 "a 3×3 s2 conv on an even input")
            enter = functools.partial(self._packed_stem, train=train, dtype=dtype,
                                      mesh=mesh)
        if spatial is not None:
            return self._spatial_features(x, dtype, spatial, train)
        conv = functools.partial(self._conv, train=train, dtype=dtype, mesh=mesh)
        return self._walk(x.to(dtype), len(self.spec.blocks), conv,
                          enter=enter)[1]

    def _packed_stem(self, x, train: bool, dtype, mesh):
        """Blocks 0-1 as the packed stem on NHWC ``x`` (the JAX package's
        ``_packed_stem_train``): the packed weights gathered from the
        canonical ``convs["0"/"1"].weight``
        (:func:`~.stem_opt.pack_stem_weights`, so the gradients reach them
        exactly), and block 0's batch norm on the packed (B, 4·C1, h, w)
        output viewed as (4·B, C1, h, w): the four parity planes partition
        the frame's positions, so the statistics and the running-stat
        update are the plain path's up to summation order (the global
        batch's under a process ``mesh``). Returns block 1's activation
        and the walk's first two slots."""
        c0, c1 = self.convs["0"], self.convs["1"]
        slope = self.spec.net.leaky_slope
        w1p, w2p = pack_stem_weights(c0.weight, c1.weight)
        y = F.conv2d(pack_input(x).permute(0, 3, 1, 2), w1p.to(dtype), None, 1, 1)
        B, c4, h, w = y.shape
        y = c0.bn(y.reshape(4 * B, c4 // 4, h, w), dtype, train, mesh)
        y = _leaky(y.reshape(B, c4, h, w), slope)
        y = c1.bn(F.conv2d(pad_packed(y), w2p.to(dtype)), dtype, train, mesh)
        y = _leaky(y, slope).permute(0, 2, 3, 1)
        return y, [y, y]

    def _spatial_features(self, x, dtype, spatial, train: bool):
        if train or any(c.split is not None for c in self.convs.values()):
            raise ValueError("the spatial forward is the eval forward of a "
                             "model with whole weights")
        rows = spatial_rows(self.spec.net.height, coarsest_stride(self.spec),
                            spatial.size)
        mine = rows[spatial.rank]
        if x.shape[1] != mine.stop - mine.start:
            raise ValueError(f"rank {spatial.rank} holds frame rows {mine}, got "
                             f"{x.shape[1]} rows")

        def conv(i, h):
            b = self.spec.blocks[i]
            pad = (b.size - 1) // 2
            h = halo_exchange(h, spatial, 1, *_halo_rows(b.size, b.stride, pad))
            y = self.convs[str(i)](h.permute(0, 3, 1, 2), dtype, False,
                                   padding=(0, pad))
            return y.permute(0, 2, 3, 1)

        pool = functools.partial(_spatial_maxpool, mesh=spatial)
        heads = self._walk(x.to(dtype), len(self.spec.blocks), conv, pool)[1]
        return [gather_blocks(h, spatial, 1, [(r.stop - r.start) * h.shape[1]
                                              // x.shape[1] for r in rows])
                for h in heads]

    def trees(self):
        """The ``(params, state)`` trees of the current values (detached
        copies)."""
        params, state = {}, {}
        for key, m in self.convs.items():
            p = {"w": m.weight.detach().clone()}
            if hasattr(m, "bn"):
                p["bn"] = {"scale": m.bn.weight.detach().clone(),
                           "bias": m.bn.bias.detach().clone()}
                state[key] = {"mean": m.bn.running_mean.clone(),
                              "var": m.bn.running_var.clone()}
            else:
                p["b"] = m.bias.detach().clone()
            params[key] = p
        return params, state

    def folded(self):
        """The current weights BN-folded (:func:`fold_bn`), the tree the
        serving :class:`Darknet` takes."""
        with torch.no_grad():
            return fold_bn(*self.trees(), self.spec)
