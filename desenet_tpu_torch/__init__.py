"""desenet_tpu_torch — the PyTorch/CUDA port of desenet_tpu for NVIDIA
Hopper (H100).

The JAX package ``desenet_tpu`` stays the reference: every module here keeps
its counterpart's file path and function names, and the tests hold each one
against it on the CPU. This package imports ``torch`` and never JAX, and
nothing of ``desenet_tpu``: what it needs of that package's numpy-only
modules (the server, the metrics, the validation data pipeline, a few host
utilities) it keeps as its own copies.

Covered so far: the serving path of ``yolov5s_seg`` (model forward, Detect
decode, single-label NMS, seg tail), its validation path (multi-label
NMS, the fused eval seg head, ``eval.Validator``, ``cli.val`` with TTA,
ensembles and COCO scoring), ``cli.detect`` and ``api.load_predictor``,
the training path and the two
probe kernels (the stem conv and the fused C3 block), with the JAX
package's six Pallas kernels rewritten as CUDA C++ kernels for ``sm_90a``
(``csrc/``), built with nvcc at first use.
"""

__version__ = "0.1.0"
