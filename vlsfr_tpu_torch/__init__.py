"""vlsfr_tpu_torch — the PyTorch / CUDA port of ``vlsfr_tpu``.

Same layout and names as the JAX package, so each module's counterpart is
found by path; inside each module the code is PyTorch idiom (``nn.Module``s,
explicit devices and ``torch.Generator``s, ``torch.autograd.Function`` for
the fused quad head). Public functions keep the JAX layouts: backbones take
NHWC ``[B, H, W, 3]`` images, embeddings are ``[B, D]`` fp32, the DCP queue
is ``[2, Q, D]``.

The package imports ``torch`` and numpy only — never JAX nor anything of
``vlsfr_tpu`` (tests/test_torch_imports.py). The TPU kernels on the ported
path are hand-written CUDA in ``csrc/``, built with ``nvcc`` at first use.

    config.py   — run configuration (copy of the JAX dataclass tree)
    core/       — LRU, DCP planner, FFC train step
    data/       — record store, synthetic raw-pixel store, FFC pipeline
    models/     — toy and IResNet backbones, flax→torch weight carrier
    ops/        — dense margin losses, the quad head, the streaming
                  margin-softmax (dense and sparse d_w) and their CUDA kernels
    optim/      — SGD and schedules
    parallel/   — the full-softmax loss and partial-FC class sampling
    train/      — single-device trainer: FFC and full-softmax heads, sparse
                  classifier row updates
    utils/      — metrics logging, device resolution, kernel parity checks
"""

__version__ = "0.1.0"
