"""PyTorch/CUDA port of the LlamaF reproduction (``repro``), for one NVIDIA H100.

The package mirrors ``repro``'s module layout (configs, core, kernels,
models, serving, launch) so each function has a findable counterpart, and
imports only ``torch``, ``numpy`` and the standard library. The group-wise
W8A8 projections run through hand-written CUDA kernels (``csrc/gqmm.cu``,
bound in ``kernels/gqmv.py``); every other operation is plain PyTorch.

Entry points (``models.transformer.init_lm``, ``serving.engine.InferenceEngine``,
``launch.serve``) run on ``cuda`` unless the caller passes ``device="cpu"``;
they never fall back to the CPU on their own.
"""
