"""Per-env physics for mjtpu_torch (port of mjtpu/parallel): domain
randomization over one batched step.  mjtpu's sharding and chunking
helpers serve a TPU mesh and are not carried over."""

from mjtpu_torch.parallel.randomize import (
    model_axes,
    randomize,
    randomize_with_consts,
    randomized_step,
)
