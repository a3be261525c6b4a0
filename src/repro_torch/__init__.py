"""repro_torch: the MemANNS/UpANNS IVF-PQ retrieval system in PyTorch + CUDA.

A port of the JAX/Pallas package `repro` to one NVIDIA H100.  It keeps the
reference's layout (`core/`, `kernels/`, `retrieval/`, `data/`, and for the
dense LM serving path `configs/`, `models/`, `launch/`) and imports
neither JAX nor `repro`: pure-numpy host logic (placement, scheduling) and
pure-data modules (model and retrieval configs) are carried as its own
copy.  Every kernel (LUT builds, ADC scans, exact re-rank, flash-attention
forward) is hand-written CUDA C++ for sm_90a under `csrc/`, built with
nvcc on first use and bound with ctypes.

Every entry point runs on `cuda` unless the caller passes `device="cpu"`;
without a GPU it raises instead of falling back.  On the CPU each kernel
wrapper runs its plain PyTorch version, which is how the tests run.

Numerics: importing this package sets `torch.backends.cuda.matmul.allow_tf32`
and `torch.backends.cudnn.allow_tf32` to False.  Every float32 product on
the card (coarse assignment, k-means, PQ encoding) then runs in full f32, as
the reference does; TF32 keeps about three decimal digits, which would move
cluster assignments.  It also sets
`torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction` to
False: by default cuBLAS may reduce bf16 products in bf16, while the
reference accumulates bf16 matmuls (the LM's projections and MLP) in f32.
"""

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
