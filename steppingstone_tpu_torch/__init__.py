"""steppingstone_tpu_torch — the PyTorch/CUDA port of steppingstone_tpu.

Same subpackage layout and module names as the JAX package, so each
counterpart is easy to find; inside, PyTorch idiom: batched functions over
a leading env axis (where the JAX code is written per env and `vmap`-ed),
`nn.Module`s, explicit devices and explicit `torch.Generator`s.

- `core/`     quaternion / 6D spatial algebra
- `physics/`  articulated rigid-body engine; the 60 Hz control step runs
              as the hand-written CUDA kernel `csrc/control_step.cu` on the
              card and as plain PyTorch on the CPU (`physics/step_kernel.py`)
- `envs/`     stepping-stone envs, terrain, curriculum state, `VecEnv`
- `agents/`   policy/value networks, Gaussian policy, rollout collection
- `parallel/` the env fleet sharded over torch.distributed ranks, one
              process per GPU, the learner replicated

Entry points run on `cuda` unless the caller passes `device="cpu"`; with
no GPU present they raise rather than fall back.
"""

__version__ = "0.1.0"
