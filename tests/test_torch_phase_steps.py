"""The one-step parity tests of ``test_torch_train_step.py`` on
``motion_init`` and ``mask_init``, in a file of their own so that two test
workers compile the JAX steps at once."""

import pytest

from torch_test_threads import two_torch_threads  # noqa: F401
from test_torch_train_step import (  # noqa: F401
    run_step,
    test_batch_stats_match,
    test_cpu_step_launches_no_kernel,
    test_gradients_match,
    test_losses_match,
    test_params_after_adam_match,
)


@pytest.fixture(scope="module", params=["motion_init", "mask_init"])
def step_results(request):
    return run_step(request.param)
