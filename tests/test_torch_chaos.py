"""The port's chaos runner (``distlearn_tpu_torch/tools/chaos.py``) on the
CPU: the scenarios of ``tests/test_chaos.py``, ``tests/test_elastic.py``,
``tests/test_router.py`` and ``tests/test_obsplane.py`` over the port's
AsyncEA roles and serving fleet, with those files' marks and assertions.
The AsyncEA runs use the JAX tool's leaves and seeds, the serving fleets
serve the JAX tool's LM weights (``lm_from_jax``), and the unkilled
reference run's center and client params are the JAX tool's bit for bit.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from distlearn_tpu.utils.logging import set_verbose as jset_verbose  # noqa: E402
from distlearn_tpu_torch.tools import chaos  # noqa: E402
from distlearn_tpu_torch.utils.logging import set_verbose  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "tools"))

import chaos as jchaos  # noqa: E402

set_verbose(False)
jset_verbose(False)

pytestmark = pytest.mark.chaos


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def serve_params():
    """The JAX tool's serving weights (``_lm_params``) in the port's
    layout."""
    from distlearn_tpu.models.transformer import transformer_lm
    from distlearn_tpu_torch.models.convert import lm_from_jax
    params, _ = transformer_lm(**jchaos._SERVE_LM).init(
        jax.random.PRNGKey(0))
    return lm_from_jax(jax.device_get(params))


def _scenario(name, rounds, **kw):
    return chaos.run_scenario(name, rounds=rounds, device="cpu", **kw)


def _bits(a: np.ndarray) -> np.ndarray:
    a = np.ascontiguousarray(a)
    return a.reshape(-1).view(np.dtype(f"u{a.dtype.itemsize}"))


# -- the parity oracle against the JAX tool --------------------------------------

@pytest.mark.parametrize("rounds,overlap", [(6, True), (9, False)])
def test_reference_run_matches_the_jax_tool_bit_for_bit(rounds, overlap):
    """The unkilled S=1 raw-wire reference that every parity soak holds
    its fleet to: the port's center and client params after ``rounds``
    drift-and-sync rounds are the JAX tool's, bit for bit."""
    host = "127.0.0.1"
    jp, jcenter = jchaos._run_reference(host, rounds, overlap)
    pp, pcenter = chaos._run_reference(host, rounds, overlap,
                                       device="cpu")
    assert len(pcenter) == len(jcenter) == len(chaos._SHAPES)
    for got, want in zip(pcenter, jcenter):
        assert got.dtype == want.dtype and got.shape == want.shape
        np.testing.assert_array_equal(_bits(got), _bits(want))
    assert sorted(pp) == sorted(jp)
    for k in jp:
        np.testing.assert_array_equal(_bits(pp[k].numpy()), _bits(jp[k]))


def test_size_keywords_default_to_the_jax_tool():
    sz = chaos.Sizes()
    assert sz.shapes == jchaos._SHAPES
    assert sz.lm == jchaos._SERVE_LM and sz.prefix_len == 24
    assert sz.prompt_lens == (3, 9) and sz.prefill_chunk is None
    got = chaos._serve_prompts(5, 3, sz)
    want = jchaos._serve_prompts(5, 3)
    assert [p.tolist() for p in got] == [p.tolist() for p in want]
    got = chaos._prefixed_prompts(6, 2, sz)
    want = jchaos._prefixed_prompts(6, 2)
    assert [p.tolist() for p in got] == [p.tolist() for p in want]
    for k, v in chaos._params(device="cpu").items():
        np.testing.assert_array_equal(v.numpy(), jchaos._params()[k])
    with pytest.raises(ValueError):
        chaos.run_scenario("nope", device="cpu")
    with pytest.raises(ValueError):
        chaos.run_scenario("flash_join", rounds=4, device="cpu")


# -- tests/test_chaos.py ---------------------------------------------------------

def test_parity_boundary_kill_promote_rejoin():
    report = chaos.run_parity(rounds=16, kills=(5,), shards=4, device="cpu")
    assert report["failures"] == []
    assert report["promotions"] == 1
    assert report["redials"] >= 1
    assert sum(report["replays"].values()) == 1


def test_parity_double_kill_ping_pongs_windows():
    report = chaos.run_parity(rounds=14, kills=(4, 9), shards=4,
                              device="cpu")
    assert report["failures"] == []
    assert report["promotions"] == 2


def test_parity_mid_stripe_kill_replays_pending_delta():
    report = chaos.run_parity(rounds=12, kills=(6,), shards=4,
                              mid_flight=True, device="cpu")
    assert report["failures"] == []
    assert sum(report["replays"].values()) == 1


def test_parity_without_overlap():
    report = chaos.run_parity(rounds=10, kills=(4,), shards=2,
                              overlap=False, device="cpu")
    assert report["failures"] == []
    assert report["promotions"] == 1


def _cli(*argv):
    r = subprocess.run(
        [sys.executable, "-m", "distlearn_tpu_torch.tools.chaos", *argv,
         "--device", "cpu"], capture_output=True, text=True, timeout=300,
        cwd=ROOT, env={**os.environ, "OMP_NUM_THREADS": "1"})
    assert r.returncode == 0, r.stderr[-800:]
    return json.loads(r.stdout[r.stdout.index("{"):])


def test_cli_parity_smoke():
    report = _cli("parity", "--rounds", "6", "--kills", "2", "--shards", "2")
    assert report["failures"] == [] and report["promotions"] == 1


@pytest.mark.elastic
def test_partition_mid_sync_heal_replays_to_bitwise_parity():
    report = _scenario("partition_heal", 12)
    assert report["failures"] == []
    assert report["dropped_bytes"] > 0
    assert report["evictions"] >= 1 and report["rejoins"] >= 1


@pytest.mark.elastic
def test_cli_scenario_smoke():
    report = _cli("scenario", "--name", "partition_heal", "--rounds", "8")
    assert report["failures"] == [] and report["rejoins"] >= 1


@pytest.mark.slow
def test_churn_soak_liveness_and_leaks():
    report = chaos.run_churn(rounds=14, num_clients=3, shards=4,
                             server_kills=2, device="cpu")
    assert report["failures"] == []
    assert report["promotions"] == report["server_kills"] == 2
    assert report["evictions"] >= 3 and report["rejoins"] >= 3


# -- tests/test_elastic.py -------------------------------------------------------

def test_scenario_flash_join_doubles_fleet_and_converges():
    report = _scenario("flash_join", 10)
    assert report["failures"] == []
    assert report["peak_members"] == 4
    assert report["dist"] <= report["tol"]


@pytest.mark.slow
def test_scenario_rolling_leave_returns_to_founding_fleet():
    report = _scenario("rolling_leave", 12)
    assert report["failures"] == []
    assert report["peak_members"] == 4 and report["final_members"] == 2


@pytest.mark.slow
def test_scenario_slow_node_stretches_tau_within_bounds():
    report = _scenario("slow_node", 12)
    assert report["failures"] == []
    lo, hi = report["tau_bounds"]
    assert lo < report["tau_slow"] <= hi
    assert report["tau_fast"] == lo


# -- tests/test_router.py --------------------------------------------------------

def test_scenario_replica_kill_every_request_terminal(serve_params):
    report = _scenario("replica_kill", 8, params=serve_params)
    assert report["failures"] == []
    assert (report["completed"] + report["failed_mid_stream"]
            == report["requests"])
    assert report["retries"] >= 1
    assert report["replicas_dispatched"] >= 2


@pytest.mark.slow
def test_scenario_slow_replica_hedges_to_the_healthy_one(serve_params):
    report = _scenario("slow_replica", 8, params=serve_params)
    assert report["failures"] == []
    assert report["completed"] == report["requests"]
    assert report["hedges"] >= 1


@pytest.mark.slow
def test_scenario_overload_shed_returns_retry_after(serve_params):
    report = _scenario("overload_shed", 8, params=serve_params)
    assert report["failures"] == []
    assert report["sheds"] == 8
    assert report["retry_after_hint"] > 0
    assert report["shed_total"] >= report["sheds"]


@pytest.mark.slow
def test_scenario_swap_during_traffic_is_epoch_fenced(serve_params):
    report = _scenario("swap_during_traffic", 8, params=serve_params)
    assert report["failures"] == []
    assert report["completed"] == report["requests"]
    assert report["fence_violations"] == 0
    assert report["swaps"] == 2
    assert set(report["stream_epochs"]) <= {1, 2}


# -- tests/test_obsplane.py ------------------------------------------------------

@pytest.mark.obsplane
def test_scenario_zipf_mix(serve_params):
    report = _scenario("zipf_mix", 8, params=serve_params)
    assert report["failures"] == []
    assert report["head_share"] >= 0.25
    assert report["completed"] == report["requests"]


@pytest.mark.obsplane
def test_scenario_diurnal(serve_params):
    report = _scenario("diurnal", 8, params=serve_params)
    assert report["failures"] == []
    assert report["breaches"] >= 1 and report["recoveries"] >= 1
    assert report["phases_breached"] >= 1


@pytest.mark.obsplane
def test_scenario_flash_crowd(serve_params):
    report = _scenario("flash_crowd", 8, params=serve_params)
    assert report["failures"] == []
    assert report["burst"] == 10 * report["baseline"]
    assert report["peak_size"] >= 2 and report["scale_ups"] >= 1
    assert report["scale_downs"] >= 1
    assert report["breaches"] >= 1 and report["recoveries"] >= 1
