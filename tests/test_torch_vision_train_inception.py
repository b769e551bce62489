"""The port's vision train step on Inception v3 and GoogLeNet vs the JAX package's:
``test_torch_vision_train_zoo.py``'s checks, sizes and bounds, in a file
of their own so that their JAX steps (the slowest of the zoo to build on
the CPU) do not hold that file's test worker."""
import pytest

from test_torch_vision_train_zoo import check_f32_step, check_f64_step


@pytest.mark.parametrize("name", ["googlenet", "inception_v3"])
def test_zoo_train_step_matches_jax(name):
    check_f32_step(name)


@pytest.mark.parametrize("name", ["inception_v3"])
def test_zoo_train_step_f64_matches_jax(name):
    check_f64_step(name)
