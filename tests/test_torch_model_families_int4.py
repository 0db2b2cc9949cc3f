"""The model families' INT4 engines on the CPU: a Qwen2-like, a
Mistral-like and a Llama-3.1-like model at debug width, born quantized
by the JAX package (``init_dummy_quantized_params``, INT4 at group 32)
and carried across, their greedy ids over two ``generate`` rounds held
against the JAX INT4 engine's, and the quantized tree's unquantized qkv
bias. The configurations and helpers are
``tests/test_torch_model_families.py``'s; the cases live apart so that
each file's JAX compiles stay small in its test worker.
"""

import pytest

from test_torch_model_families import (  # noqa: F401 (a fixture)
    FAMILIES, _torch_threads, dummy_bias_matches_jax, generate_against_jax)


@pytest.mark.parametrize("family", list(FAMILIES))
def test_int4_generate_greedy_ids_match_jax_over_two_rounds(rng, family):
    generate_against_jax(rng, family, "int4", "slot")


def test_dummy_bias_stays_unquantized_as_in_jax():
    dummy_bias_matches_jax(True)
