"""The port's decode-path perplexity (utils/perplexity.decode_ppl) against
the JAX package's (tests/test_quant_ppl.py::decode_ppl: jitted prefill and
decode_step, the flash-decode and quantized-matmul kernels in interpret
mode) on the same parameters, the JAX package's initial ones carried
across by params_from_jax, for each cache mode (float32, fp8, int8) and
each weight mode (int8, int4 weight-only), on the quality gate's config
(tests/test_torch_quant_ppl.py) and the first 16 of its tokens (the JAX
side's decode steps compile once a mode; a file of its own keeps each file
under 30 s). Tolerance rel 1e-4: float32 logits through two layers with
sums in another order, the quantizations bit for bit the jitted JAX
arithmetic."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flashattn_tpu.models import generate as jax_generate
from flashattn_tpu.models import llama as jax_llama
from flashattn_tpu_torch.models import llama
from flashattn_tpu_torch.utils.perplexity import decode_ppl
from test_torch_quant_ppl import JCFG, jax_init, jax_tokens, port_model

# One intra-op thread: the suite's workers share the machine's cores.
torch.set_num_threads(1)

PARITY_TOKENS = 16  # prefill, then 14 decode steps
PARITY_RTOL = 1e-4


@pytest.fixture(scope="module")
def params():
    return jax_init()


def jax_decode_ppl(params, tokens: np.ndarray, quant) -> float:
    """The JAX test's decode_ppl (tests/test_quant_ppl.py)."""
    b, s1 = tokens.shape
    caches = jax_generate.init_caches(JCFG, b, 128, quant=quant)
    tokens = jnp.asarray(tokens)
    logits, caches = jax_generate.prefill(params, tokens[:, :1], caches, JCFG)
    nll = 0.0
    for t in range(1, s1):
        target = tokens[:, t]
        logp = jax.nn.log_softmax(logits, axis=-1)
        nll += float(-jnp.take_along_axis(logp, target[:, None], axis=-1).sum())
        if t < s1 - 1:
            positions = jnp.full((b,), t, jnp.int32)
            logits, caches = jax_generate.decode_step(params, target, positions, caches, JCFG)
    return float(np.exp(nll / (b * (s1 - 1))))


@pytest.mark.parametrize("quant,bits", [(None, 0), ("fp8", 0), ("int8", 0), (None, 8),
                                        (None, 4)],
                         ids=["float32", "fp8", "int8", "w8", "w4"])
def test_decode_ppl_matches_jax(params, quant, bits):
    tokens = jax_tokens()[:, :PARITY_TOKENS]
    model = port_model(params)
    if bits:
        params = jax_llama.quantize_params(params, bits=bits)
        model = llama.quantize_params(model, bits=bits)
    want = jax_decode_ppl(params, tokens, quant)
    got = decode_ppl(model, torch.from_numpy(tokens.copy()), quant=quant)
    assert got == pytest.approx(want, rel=PARITY_RTOL), (want, got)
