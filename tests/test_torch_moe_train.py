"""loss_fn's loss and every parameter's gradient (router, experts, the
shared expert) on tests/test_torch_moe_model.py's two mixture-of-experts
models against jax.value_and_grad of the JAX loss_fn, the model of
tests/test_moe_model.py (its gradient flows through the grouped dispatch's
products, gathers and gates here, through the masked-dense loop there).
Training on the card is ROADMAP's next MoE item.

float32: the loss within rel 1e-5, the gradients within atol 1e-5, rtol
1e-4 (tests/test_torch_train.py's gates)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flashattn_tpu.models import llama as jax_llama
from flashattn_tpu_torch.models import llama
from flashattn_tpu_torch.models.convert import params_from_jax
from flashattn_tpu_torch.utils.verify import verify_results
from tests.test_torch_moe_model import moe_models  # noqa: F401 (the fixture)

# One intra-op thread: the suite's workers share the machine's cores, and
# torch would start one thread a core in each of them.
torch.set_num_threads(1)


def test_moe_loss_and_grads_match_jax(moe_models):
    _, jcfg, params, model = moe_models
    tokens = np.random.default_rng(4).integers(0, jcfg.vocab_size, (2, 33), dtype=np.int32)
    jloss, jgrads = jax.value_and_grad(jax_llama.loss_fn)(params, jnp.asarray(tokens), jcfg)
    model.zero_grad(set_to_none=True)
    loss = llama.loss_fn(model, torch.from_numpy(tokens))
    loss.backward()
    assert float(loss.detach()) == pytest.approx(float(jloss), rel=1e-5)
    sd = params_from_jax(jax.tree_util.tree_map(np.asarray, jgrads))
    assert set(sd) == {name for name, _ in model.named_parameters()}
    for name, p in model.named_parameters():
        rep = verify_results(sd[name], p.grad, atol=1e-5, rtol=1e-4)
        assert rep.passed, f"grad {name}: {rep}"
    model.zero_grad(set_to_none=True)
