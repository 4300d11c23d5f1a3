"""loss_fn's gradients with the model-family fields (Qwen3's q/k RMSNorm,
Qwen2's q/k/v biases, the llama3 and longrope RoPE variants) against the
JAX package's jax.value_and_grad, with remat False and "attn" (under
"attn" the biases' and norms' gradients come from attention_operands'
registered backward). Float32 on the CPU; loss rel 1e-5, gradients atol
1e-5 / rtol 1e-4 (tests/test_torch_remat.py's). The configs and weights
are tests/test_torch_model_families.py's."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flashattn_tpu.models import llama as jax_llama
from flashattn_tpu_torch.models import llama
from flashattn_tpu_torch.models.convert import params_from_jax
from flashattn_tpu_torch.utils.verify import verify_results

from tests.test_torch_model_families import FAMILIES, KW, make_models

torch.set_num_threads(1)


@pytest.mark.parametrize("remat", [False, "attn"])
@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_loss_gradients_match_jax(family, remat):
    """loss_fn's gradients, the biases' and the q/k norms' included (under
    remat="attn" they come from attention_operands' registered backward)."""
    jcfg, params, model = make_models(family, seed=2)
    toks = np.random.default_rng(3).integers(0, KW["vocab_size"], (2, 41), dtype=np.int32)
    value_and_grad = jax.jit(jax.value_and_grad(jax_llama.loss_fn), static_argnums=(2, 6))
    jloss, jgrads = value_and_grad(params, jnp.asarray(toks), jcfg, None, None, None, remat)
    loss = llama.loss_fn(model, torch.from_numpy(toks), remat=remat)
    loss.backward()
    assert float(loss.detach()) == pytest.approx(float(jloss), rel=1e-5)
    ref = params_from_jax(jax.tree_util.tree_map(np.asarray, jgrads))
    grads = {n: p.grad for n, p in model.named_parameters()}
    assert set(grads) == set(ref)
    extra = {n for n in grads if n.rsplit(".", 1)[-1] in ("bq", "bk", "bv", "q_norm", "k_norm")}
    assert bool(extra) == (family in ("qk_norm", "attn_bias"))
    for name, g in grads.items():
        rep = verify_results(ref[name], g, atol=1e-5, rtol=1e-4)
        assert rep.passed, f"grad {name}: {rep}"
