"""The port's train step (``repro_torch.launch.steps.make_train_step``)
vs the JAX package's, on the CPU.

Both packages start from the reference's weights (``from_reference``) and
take the same numpy-seeded batches (``_train_ref.run_steps``): three steps
of each package's step (the reference's under ``jax.jit``) for a dense, a
MoE (both dispatches), an SSM and a hybrid architecture; loss, ce, aux,
``grad_norm``, ``lr``, every parameter and both moments after each step at
rtol = atol = 2e-4 (measured: at most 3.3e-6 on the metrics and 4.9e-5 on
the parameters, the largest on the attention's key bias: its gradient is
small, and AdamW moves an entry by about the step size, 1e-3, whatever
its gradient's size, so the gradient's rounding shows there).  The
reported loss is ``ce + aux_weight * aux``, as the reference's with one
microbatch.  ``test_torch_steps.py`` holds two microbatches,
``attn_plan``, ``input_specs`` and ``to_reference``;
``test_torch_trainloop.py`` the trainer.
"""

import pytest

from _train_ref import run_steps

# dense, MoE (einsum and sorted dispatch), SSM, hybrid
STEP_ARCHS = [("qwen2-0.5b", None), ("qwen2-moe-a2.7b", "einsum"),
              ("qwen2-moe-a2.7b", "sorted"), ("mamba2-780m", None), ("hymba-1.5b", None)]


@pytest.mark.parametrize("name,dispatch", STEP_ARCHS)
def test_train_steps_equal_reference(name, dispatch):
    run_steps(name, dispatch, n_micro=1)
