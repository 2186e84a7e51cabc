"""PyTorch + CUDA port of the racing-perception framework, for one NVIDIA H100.

The JAX package ``mit_driverless_cv_traininginfra_tpu`` beside this one is
the reference: every module here keeps the name of its counterpart there
(``models/darknet.py`` ↔ ``models/darknet.py``), and the public functions
keep its layouts (frames NHWC ``(B, H, W, 3)``, decode ``(B, N, 5)``, crops
``(N, 80, 80, C)``). This package imports ``torch``, never ``jax`` and
nothing of the JAX package; it keeps its own copies of the jax-free
modules it needs (``config/``, ``infer/capacity.py``, ``data/synthetic.py``).

Ported so far: the bf16/f32 two-stage serving path

    frames ─ Darknet YOLOv3 (BN folded, 1-class heads) ─ decode
           ─ threshold/top-k/NMS (CUDA kernel K3)
           ─ batch-global crop compaction ─ 80×80 ROI crop (CUDA kernel K1)
           ─ RektNet ─ soft-argmax (CUDA kernel K2) ─ keypoints in frame px

and the ``TwoStageServer`` around it; the int8 configuration with the
fused entry block (K4); the int8 residual stage (K5, ``ops/resstage.py``)
on its own path; and RektNet training (``train/``), whose soft-argmax
backward is kernel K2's backward. The kernels are hand-written CUDA C++
for ``sm_90a`` under ``csrc/``, built with ``nvcc`` at first use
(``ops/_lib.py``). Each has a plain PyTorch version in the same module,
which its wrapper takes for CPU tensors only.
"""

__version__ = "0.1.0"
