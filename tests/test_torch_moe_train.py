"""loss_fn's loss and every parameter's gradient (router, experts, the
shared expert) on tests/test_torch_moe_model.py's two mixture-of-experts
models against jax.value_and_grad of the JAX loss_fn, the model of
tests/test_moe_model.py (its gradient flows through the grouped dispatch's
products, gathers and gates here, through the masked-dense loop there);
three AdamW train_steps of each against the JAX package's (optax)
train_step; and one AdamW train_step of TINY_MOE under data 2 x ep 2 on
four gloo ranks (tests/_torch_parallel_worker.py, each rank its block of
every layer's experts, both dispatches) against the same step in one
process. chip_smoke.py phase 22 trains the MoE models on the card.

float32: the loss within rel 1e-5, the gradients within atol 1e-5, rtol
1e-4 (tests/test_torch_train.py's gates). The parameters after AdamW steps
take tests/test_torch_train.py's rule for them: at most 1 in 10^4 entries
beyond 1e-6, none beyond 1e-4, the mean difference below 1e-7. Adam
divides by sqrt(v), so an entry whose gradient is near zero turns a
float32 difference far below 1e-6 into an update difference of up to
about 1e-4 (here 4.7e-5 at most, the mean 3e-9). Under the mesh the loss
within rel 2e-5 and the grad norm within rel 1e-5 (tests/test_torch_moe_ep.py's
model gates), the clipped gradients within atol 1e-5, rtol 1e-4, the
updated parameters under the rule above."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _parallel_harness import Ranks
from flashattn_tpu.models import llama as jax_llama
from flashattn_tpu.models import train as jax_train
from flashattn_tpu_torch.models import llama, train
from flashattn_tpu_torch.models.config import TINY_MOE
from flashattn_tpu_torch.models.convert import params_from_jax
from flashattn_tpu_torch.utils.verify import verify_results
from tests.test_torch_moe_model import moe_models  # noqa: F401 (the fixture)

# One intra-op thread: the suite's workers share the machine's cores, and
# torch would start one thread a core in each of them.
torch.set_num_threads(1)

TOL = dict(atol=1e-5, rtol=1e-4)
TC_KW = dict(learning_rate=1e-3, warmup_steps=2, total_steps=50)  # tests/test_torch_train.py's
EP_TC = train.TrainConfig(learning_rate=1e-3, warmup_steps=0, total_steps=50)  # lr 1e-3 at once
DISPATCHES = ("a2a", "dense")  # cfg.moe_dispatch under the ep axis


def ep_case(dispatch: str) -> dict:
    """TINY_MOE in float32 from a seed (the port's init), 4 rows of 17
    tokens, the mesh data 2 x ep 2."""
    cfg = dataclasses.replace(TINY_MOE, dtype=torch.float32, moe_dispatch=dispatch)
    model = llama.init_params(cfg, torch.Generator().manual_seed(11), device="cpu")
    tokens = np.random.default_rng(12).integers(0, cfg.vocab_size, (4, 17)).astype(np.int32)
    return dict(mesh={"data": 2, "ep": 2}, cfg=cfg, tc=EP_TC, tokens=tokens,
                params={n: p.detach().clone() for n, p in model.named_parameters()})


def adam_close(want: dict, got: dict, what: str) -> list[str]:
    """tests/test_torch_train.py's rule for parameters after AdamW steps on
    two {name: tensor} maps: every entry within 1e-4, at most 1 in 10^4
    beyond 1e-6, each tensor's mean difference below 1e-7. Returns the
    failures."""
    failures, beyond, total = [], 0, 0
    for name, ref in want.items():
        err = (got[name].detach().float() - ref.detach().float()).abs()
        if float(err.max()) > 1e-4 or float(err.mean()) >= 1e-7:
            failures.append(f"{what} {name}: max {float(err.max()):.3e}, "
                            f"mean {float(err.mean()):.3e}")
        beyond += int((err > 1e-6).sum())
        total += err.numel()
    if beyond > 1e-4 * total:
        failures.append(f"{what}: {beyond} of {total} entries beyond 1e-6")
    return failures


@pytest.fixture(scope="module", autouse=True)
def ep_ranks(tmp_path_factory):
    """The ep step's four ranks, started before this file's JAX tests run."""
    return Ranks("moe_train", 4, {d: ep_case(d) for d in DISPATCHES},
                 tmp_path_factory.mktemp("ranks"))


def test_moe_loss_and_grads_match_jax(moe_models):
    _, jcfg, params, model = moe_models
    tokens = np.random.default_rng(4).integers(0, jcfg.vocab_size, (2, 33), dtype=np.int32)
    jloss, jgrads = jax.jit(jax.value_and_grad(jax_llama.loss_fn), static_argnums=2)(
        params, jnp.asarray(tokens), jcfg)
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


def test_moe_adamw_steps_match_optax(moe_models):
    """Three AdamW train_steps (warmup 2: lr 0, 5e-4, then 1e-3) against the
    JAX train_step from the same weights: each step's loss and raw
    grad_norm, then every parameter."""
    _, jcfg, params, fixture_model = moe_models
    model = llama.Llama(fixture_model.cfg, device="cpu")  # the fixture's stays as it is
    model.load_state_dict(fixture_model.state_dict())
    jtc = jax_train.TrainConfig(**TC_KW)
    jstate = jax_train.init_train_state(params, jtc)
    state = train.init_train_state(model, train.TrainConfig(**TC_KW))
    tokens = np.random.default_rng(5).integers(0, jcfg.vocab_size, (2, 33), dtype=np.int32)
    for step in range(3):
        jstate, jm = jax_train.train_step(jstate, jnp.asarray(tokens), jcfg, jtc)
        state, m = train.train_step(state, torch.from_numpy(tokens))
        assert float(m["loss"]) == pytest.approx(float(jm["loss"]), rel=1e-5), step
        assert float(m["grad_norm"]) == pytest.approx(float(jm["grad_norm"]), rel=1e-4), step
    assert state["step"] == int(jstate["step"]) == 3
    sd = params_from_jax(jax.tree_util.tree_map(np.asarray, jstate["params"]))
    got = dict(model.named_parameters())
    assert set(sd) == set(got)
    failures = adam_close(sd, got, "after 3 steps")
    assert not failures, "\n".join(failures)


@pytest.mark.parametrize("dispatch", DISPATCHES)
def test_moe_adamw_step_under_ep_matches_one_process(ep_ranks, dispatch):
    """One AdamW train_step of TINY_MOE under data 2 x ep 2 (moe_ffn_a2a or
    the masked-dense moe_ffn) against train_step in this process on the
    same weights and tokens: every rank's loss and grad norm, and its
    clipped gradients and updated parameters gathered whole."""
    case = ep_case(dispatch)
    model = llama.Llama(case["cfg"], device="cpu")
    model.load_state_dict(case["params"])
    state, m = train.train_step(train.init_train_state(model, EP_TC),
                                torch.from_numpy(case["tokens"]))
    failures = []
    for r, res in enumerate(ep_ranks.results()):
        got = res[dispatch]
        if abs(got["loss"] - float(m["loss"])) > 2e-5 * abs(float(m["loss"])):
            failures.append(f"rank {r} loss {got['loss']} vs {float(m['loss'])}")
        if abs(got["grad_norm"] - float(m["grad_norm"])) > 1e-5 * float(m["grad_norm"]):
            failures.append(f"rank {r} grad_norm {got['grad_norm']} vs {float(m['grad_norm'])}")
        for name, p in model.named_parameters():
            rep = verify_results(p.grad, got["grads"][name], **TOL)
            if not rep.passed:
                failures.append(f"rank {r} grad {name}: {rep}")
        failures += adam_close(dict(model.named_parameters()), got["params"],
                               f"rank {r} updated")
    assert not failures, "\n".join(failures[:20])
