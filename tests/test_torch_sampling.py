"""Port parity for seeded temperature sampling: the draw (`repro_torch.core.
prng`), the sampler (`prng.sample_tokens`) and the continuous
engine's sampled tokens, against the JAX package.

  * The bits: `prng.random_bits32` equals `jax.random.bits` and the numpy
    threefry of `core.saliency` bit for bit, over seeds -5, 0, 7, 2**31 - 1
    and a random one, counters 0-1024, vocab 256 and 64000.
  * The Gumbel noise is within 2.5e-7 * (1 + |g|) of `jax.random.gumbel` on
    the same key: only the two frameworks' `log` differ (by under 1e-6
    absolute, thousands of ulps near g = 0, hence a relative bound).
  * `sample_tokens` equals the reference's `_sample_tokens` token for token
    on the same logits (f32 and bf16), temperatures 0, 1e-4, 0.7, 1, 2;
    temperature-0 rows are bitwise `argmax`.
  * Over counters 0-19,999 on one logit row, the frequencies stay within the
    chi-square bound of softmax(logits / T) (deterministic: fixed counters).
  * The engine: tests/test_serving.py's slot-independence scenario (T 0.8,
    seed 7) on the port's engine and on the JAX engine (op by op,
    `jax.disable_jit()`), both placements equal and equal to the JAX
    engine's; temperature-0 rows of a mixed batch bitwise an all-greedy
    run; the static-buffer step route equal to capture=False.

Every JAX draw runs under `jax.threefry_partitionable(True)`, the mode the
port follows; no test here changes jax's configuration.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.core.policy import CompressionConfig as JCompression
from repro.models import registry as jregistry
from repro.serving import ContinuousEngine as JContinuousEngine
from repro.serving import Request as JRequest
from repro.serving import SamplingParams as JSamplingParams
from repro.serving import ServeConfig as JServeConfig
from repro.serving.engine import _sample_tokens
from repro_torch import configs, convert
from repro_torch.core import prng
from repro_torch.core.prng import SAMPLES, sample_tokens
from repro_torch.core import saliency as sal
from repro_torch.core.policy import CompressionConfig
from repro_torch.serving import ContinuousEngine, Request, SamplingParams, ServeConfig
from tests.torch_parity import to_torch, torch_threads  # noqa: F401

pytestmark = pytest.mark.usefixtures("torch_threads")
SEEDS = (-5, 0, 7, 2**31 - 1, int(np.random.default_rng(21).integers(-2**31, 2**31)))
TEMPS = (0.0, 1e-4, 0.7, 1.0, 2.0)


def _keys(seed: int, counters) -> torch.Tensor:
    counters = torch.as_tensor(counters, dtype=torch.int32)
    return prng.fold_in(prng.key(torch.full_like(counters, seed)), counters)


def _jax_bits(seed: int, counters, n: int) -> np.ndarray:
    with jax.threefry_partitionable(True):
        key = jax.random.PRNGKey(seed)
        bits = jax.vmap(lambda c: jax.random.bits(jax.random.fold_in(key, c), (n,),
                                                  jnp.uint32))(jnp.asarray(counters))
    return np.asarray(bits).astype(np.int64)


# ---------------------------------------------------------------------------
# the draw
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("vocab", [256, 64000])
@pytest.mark.parametrize("seed", SEEDS)
def test_random_bits_equal_jax_and_numpy(seed, vocab):
    """Every counter 0-1024 at vocab 256; at 64000, counters 0, 1, 3, 511,
    1024 (a (1025, 64000) int64 sweep would take gigabytes)."""
    counters = list(range(1025)) if vocab == 256 else [0, 1, 3, 511, 1024]
    got = prng.random_bits32(_keys(seed, counters), vocab).numpy()
    np.testing.assert_array_equal(got, _jax_bits(seed, counters, vocab))
    for row, c in zip(got[::97], counters[::97]):
        want = sal._random_bits32(sal._fold_in(sal._key(seed), c), vocab).astype(np.int64)
        np.testing.assert_array_equal(row, want)


def test_key_and_fold_in_equal_jax():
    """`key` is [0, seed & 0xFFFFFFFF] (negative seeds wrap); `fold_in`
    equals jax's, data wrapping the same way."""
    seeds = torch.tensor(SEEDS, dtype=torch.int32)
    data = torch.tensor([0, 3, -1, 2**31 - 1, 77], dtype=torch.int32)
    with jax.threefry_partitionable(True):
        for i, s in enumerate(SEEDS):
            k = jax.random.PRNGKey(s)
            np.testing.assert_array_equal(prng.key(seeds)[i].numpy(), np.asarray(k))
            folded = jax.random.fold_in(k, jnp.asarray(int(data[i]), jnp.int32))
            np.testing.assert_array_equal(prng.fold_in(prng.key(seeds), data)[i].numpy(),
                                          np.asarray(folded))


@pytest.mark.parametrize("seed,counter", [(7, 3), (-5, 0), (2**31 - 1, 1024)])
def test_gumbel_within_bound_of_jax(seed, counter):
    n = 64000
    got = prng.gumbel(_keys(seed, [counter]), n)[0].numpy()
    with jax.threefry_partitionable(True):
        key = jax.random.fold_in(jax.random.PRNGKey(seed), counter)
        want = np.asarray(jax.random.gumbel(key, (n,), jnp.float32))
    assert np.isfinite(got).all()
    np.testing.assert_array_less(np.abs(got - want), 2.5e-7 * (1 + np.abs(want)))


def test_uniform_floors_at_tiny():
    """All-zero mantissa bits give tiny, never 0 (log stays finite)."""
    keys = _keys(0, list(range(64)))
    u = prng.uniform(keys, 4096)
    assert float(u.min()) >= torch.finfo(torch.float32).tiny and float(u.max()) < 1.0


# ---------------------------------------------------------------------------
# the sampler
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("vocab", [256, 64000])
def test_sample_tokens_equal_reference(vocab, dtype):
    """50 seeded draws of b = 4 rows: random logits, temperatures from TEMPS,
    int32 seeds, counters 0-511: every token equal to `_sample_tokens`', and
    temperature-0 rows bitwise `argmax`."""
    rng = np.random.default_rng(vocab)
    n_sampled = 0
    for _ in range(50):
        logits = (rng.normal(size=(4, vocab)) * 3).astype(np.float32)
        jlogits = jnp.asarray(logits).astype(dtype)
        temps = rng.choice(TEMPS, size=4).astype(np.float32)
        seeds = rng.integers(-2**31, 2**31, size=4).astype(np.int32)
        ctrs = rng.integers(0, 512, size=4).astype(np.int32)
        with jax.threefry_partitionable(True):
            want = np.asarray(_sample_tokens(jlogits, jnp.asarray(temps), jnp.asarray(seeds),
                                             jnp.asarray(ctrs)))
        tlogits = to_torch(np.asarray(jlogits))
        got = sample_tokens(tlogits, torch.from_numpy(temps), torch.from_numpy(seeds),
                            torch.from_numpy(ctrs))
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want)
        greedy = temps == 0
        np.testing.assert_array_equal(got.numpy()[greedy],
                                      torch.argmax(tlogits, -1).numpy()[greedy])
        n_sampled += int((~greedy).sum())
    assert n_sampled > 100


def test_sample_tokens_ties_take_the_lowest_index():
    """Greedy ties go to the lowest index, as `jnp.argmax`; the sampler
    neither writes its logits nor depends on the row's slot."""
    logits = torch.zeros(3, 64)
    logits[:, 5] = logits[:, 9] = 1.0
    before = logits.clone()
    temps = torch.tensor([0.0, 0.7, 0.7])
    seeds = torch.tensor([1, 4, 4], dtype=torch.int32)
    ctrs = torch.tensor([0, 2, 2], dtype=torch.int32)
    got = sample_tokens(logits, temps, seeds, ctrs)
    assert int(got[0]) == 5 and int(got[1]) == int(got[2])
    assert torch.equal(logits, before)
    alone = sample_tokens(logits[2:], temps[2:], seeds[2:], ctrs[2:])
    assert int(alone[0]) == int(got[2])


# chi-square 0.999 quantiles (scipy.stats.chi2.ppf(0.999, df))
_CHI2_999 = {15: 37.6973}


@pytest.mark.parametrize("temp", [0.7, 1.0, 2.0])
def test_frequencies_follow_softmax(temp):
    """One fixed 16-way logit row sampled at counters 0-19,999 (seed 3): the
    chi-square statistic of the counts against softmax(logits / T) stays
    below its 0.999 quantile (15 degrees of freedom, 37.70)."""
    n, vocab = 20000, 16
    row = torch.from_numpy(np.random.default_rng(5).normal(size=vocab).astype(np.float32))
    got = sample_tokens(row.expand(n, vocab), torch.full((n,), temp),
                        torch.full((n,), 3, dtype=torch.int32),
                        torch.arange(n, dtype=torch.int32))
    counts = np.bincount(got.numpy(), minlength=vocab)
    p = torch.softmax(row.double() / temp, -1).numpy()
    chi2 = float(((counts - n * p) ** 2 / (n * p)).sum())
    assert chi2 < _CHI2_999[vocab - 1], (chi2, counts, n * p)


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------

def _prompts(vocab, n=2, length=48):
    rng = np.random.default_rng(0)
    return [rng.integers(2, vocab, size=(length,)).astype(np.int32) for _ in range(n)]


def _placements(make, request, sampling):
    """tests/test_serving.py's scenario: the sampled request alone (slot 0),
    then behind a short greedy request admitted first (slot 1, one step
    later) -> (tokens in slot 0, tokens in slot 1)."""
    prompts = _prompts(make.vocab)
    eng = make()
    a = eng.submit(request(tokens=prompts[1], sampling=sampling))
    first = eng.run()[a].tokens.tolist()
    eng = make()
    eng.submit(request(tokens=prompts[0], max_new_tokens=3))
    eng.step()
    b = eng.submit(request(tokens=prompts[1], sampling=sampling))
    return first, eng.run()[b].tokens.tolist()


class _Maker:
    def __init__(self, fn, vocab):
        self.fn, self.vocab = fn, vocab

    def __call__(self, **kw):
        return self.fn(**kw)


@pytest.fixture(scope="module")
def engines():
    jcfg = jconfigs.get_arch("yi-6b", smoke=True)
    jccfg = dataclasses.replace(JCompression.zipcache(), fp_window=8, recompress_interval=8)
    jparams = jregistry.materialize_params(jcfg, seed=0)
    jscfg = JServeConfig(batch_size=2, prompt_len=48, max_new_tokens=6)
    with jax.threefry_partitionable(True), jax.disable_jit():
        reference = _placements(
            _Maker(lambda: JContinuousEngine(jcfg, jccfg, jscfg, jparams), jcfg.vocab),
            JRequest, JSamplingParams(temperature=0.8, seed=7))
    cfg = configs.get_arch("yi-6b", smoke=True)
    ccfg = dataclasses.replace(CompressionConfig.zipcache(), fp_window=8, recompress_interval=8)
    params = convert.from_jax_params(jax.device_get(jparams), cfg, device="cpu")

    def make(capture=True, **kw):
        scfg = ServeConfig(**{**dict(batch_size=2, prompt_len=48, max_new_tokens=6), **kw})
        return ContinuousEngine(cfg, ccfg, scfg, params, device="cpu", capture=capture)

    return {"reference": reference, "make": _Maker(make, cfg.vocab), "cfg": cfg}


@pytest.mark.parametrize("layout", [dict(), dict(backend="paged", page_size=8,
                                                 page_allocator="freelist",
                                                 paged_kernel=True)],
                         ids=["mixed", "paged-kernel"])
def test_sampled_tokens_slot_independent_and_equal_reference(engines, layout):
    make = _Maker(lambda: engines["make"](**layout), engines["cfg"].vocab)
    before = SAMPLES.launches
    slot0, slot1 = _placements(make, Request, SamplingParams(temperature=0.8, seed=7))
    ref0, ref1 = engines["reference"]
    assert ref0 == ref1
    assert slot0 == slot1 == ref0
    assert len(slot0) == 6
    # one draw at each admission, one per step after it
    assert SAMPLES.launches - before == 12


def test_sampled_tokens_differ_from_greedy(engines):
    """The sampled request is not its greedy run in disguise."""
    prompt = _prompts(engines["cfg"].vocab)[1]
    eng = engines["make"]()
    rid = eng.submit(Request(tokens=prompt))
    assert eng.run()[rid].tokens.tolist() != engines["reference"][0]


@pytest.mark.parametrize("layout", [dict(), dict(backend="paged", page_size=8,
                                                 page_allocator="freelist", pool_fraction=1.0,
                                                 paged_kernel=True)],
                         ids=["mixed", "paged-kernel"])
def test_greedy_rows_of_a_mixed_batch_equal_all_greedy(engines, layout):
    """Temperature-0 rows beside sampled ones (admitted together, then one
    mid-run into a freed slot, folds on the way) are bitwise an all-greedy
    run's; an all-greedy run draws nothing."""
    prompts = _prompts(engines["cfg"].vocab, n=4, length=40)
    kw = dict(max_new_tokens=12, **layout)

    def run(sampled):
        eng = engines["make"](**kw)
        sp = [SamplingParams(temperature=0.7, seed=11) if sampled else SamplingParams(),
              SamplingParams(), SamplingParams(temperature=1.0, seed=-5) if sampled
              else SamplingParams(), SamplingParams()]
        rids = [eng.submit(Request(tokens=prompts[0], sampling=sp[0])),
                eng.submit(Request(tokens=prompts[1], sampling=sp[1], max_new_tokens=5))]
        for _ in range(3):
            eng.step()
        rids += [eng.submit(Request(tokens=p, sampling=s)) for p, s in zip(prompts[2:], sp[2:])]
        res = eng.run()
        return [res[r].tokens.tolist() for r in rids]

    before = SAMPLES.launches
    greedy = run(False)
    assert SAMPLES.launches == before
    mixed = run(True)
    assert SAMPLES.launches > before
    assert mixed[1] == greedy[1] and mixed[3] == greedy[3]
    assert mixed[0] != greedy[0] and mixed[2] != greedy[2]


@pytest.mark.parametrize("layout", [dict(), dict(backend="paged", page_size=8,
                                                 page_allocator="freelist", pool_fraction=1.0,
                                                 paged_kernel=True)],
                         ids=["mixed", "paged-kernel"])
def test_static_buffer_route_equals_eager(engines, layout):
    """The static-buffer decode step (the CPU's counterpart of the captured
    one) samples the tokens capture=False samples, through probe steps,
    folds and a mid-run admission."""
    prompts = _prompts(engines["cfg"].vocab, n=3, length=40)
    outs = []
    for capture in (True, False):
        eng = engines["make"](capture=capture, max_new_tokens=12, **layout)
        rids = [eng.submit(Request(tokens=prompts[0],
                                   sampling=SamplingParams(temperature=0.7, seed=2**31 - 1))),
                eng.submit(Request(tokens=prompts[1], max_new_tokens=4))]
        eng.step()
        rids.append(eng.submit(Request(tokens=prompts[2],
                                       sampling=SamplingParams(temperature=2.0, seed=0))))
        res = eng.run()
        outs.append([res[r].tokens.tolist() for r in rids])
        if capture:
            assert eng._decode_masked.captures == 1 and eng._decode_masked.replays > 0
    assert outs[0] == outs[1]


def test_submit_takes_sampling_and_checks_the_seed(engines):
    eng = engines["make"]()
    prompt = np.arange(2, 10, dtype=np.int32)
    eng.submit(Request(tokens=prompt, sampling=SamplingParams(temperature=0.7, seed=-2**31)))
    with pytest.raises(ValueError, match="int32"):
        eng.submit(Request(tokens=prompt, sampling=SamplingParams(temperature=0.7, seed=2**31)))
    assert len(eng.run()) == 1
