"""fpv4d_torch — the PyTorch/CUDA port of fpv4d for one NVIDIA H100.

The JAX package ``fpv4d`` is the reference; this package mirrors its
layout (config, core, models, ops, solve, utils) so each module's
counterpart is easy to find, and imports nothing from it. The only
imports are torch, numpy, ctypes and the standard library.

Numerics: float32 throughout. Importing the package turns TF32 off for
both CUDA matmuls and cuDNN (``torch.backends.cuda.matmul.allow_tf32``
and ``torch.backends.cudnn.allow_tf32`` are set to False), so every
float32 product on the card runs in full float32, as the reference's
tests run JAX at the highest matmul precision.

Entry points (``solve.clip_solve.ClipSolver``,
``utils.bench_problem.standard_problem``,
``solve.keypoint_fit.fit_keypoints``, the smoother's ``solve.frame_fit``
functions and the CLIs) take ``device=`` and default to ``"cuda"``; the
CPU is used only when the caller asks for it. The optimization loops
(the clip solve, the keypoint fit's Adam stages and the smoothers) take
``step_graphs=``: on the card each step is captured once as a CUDA graph
and replayed unless it is False (``solve/step_graph.py``).

Hand-written kernels live in ``csrc/`` and are built with nvcc at
first use into ``fpv4d_torch/_build/`` (see ``ops/cand_cuda.py``).
"""
import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

__version__ = "0.1.0"
