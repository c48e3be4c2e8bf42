"""End-to-end convergence parity (SURVEY.md section 6.5 / BASELINE.md
"Task success"): the engine trains config-1 reaching to the oracle's
return (different RNG streams, same algorithm + constants), within a
stochastic tolerance. Marked slow — the oracle side is fp64 NumPy.
"""
import numpy as np
import pytest

from oracle.trpo import train as oracle_train
from trpo_robot_control_tpu.configs import C1_REACHER2
from trpo_robot_control_tpu.trpo.train import train as engine_train

CFG = C1_REACHER2.replace(n_envs=48, horizon=40)
N_ITERS = 25


@pytest.mark.slow
def test_engine_matches_oracle_training_curve():
    _, ohist = oracle_train(CFG, n_iters=N_ITERS, seed=0)
    _, ehist = engine_train(CFG, n_iters=N_ITERS, seed=0)

    o_final = np.mean([h["mean_return"] for h in ohist[-5:]])
    e_final = np.mean([h["mean_return"] for h in ehist[-5:]])
    o_first = np.mean([h["mean_return"] for h in ohist[:3]])

    # both must improve substantially from the initial return...
    assert e_final > o_first + 0.25 * (o_final - o_first)
    # ...and land in the same neighbourhood (stochastic: different RNG).
    # Band justified by a 6-seed sweep of this exact comparison (round 3):
    # observed ratios 0.961-1.055; (0.85, 1.18) gives ~3x the observed
    # spread yet fails a materially worse engine (the round-1 band
    # 0.6-1.67 would not).
    improvement_o = o_final - o_first
    improvement_e = e_final - o_first
    ratio = improvement_e / improvement_o
    assert 0.85 < ratio < 1.18, (o_first, o_final, e_final, ratio)
