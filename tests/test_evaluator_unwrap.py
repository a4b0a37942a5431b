"""Parity of the vectorized code-phase unwrap vs the sequential walk.

`unwrap_code_phases` replaced its reference-shaped sequential loop
(cpOflCorrection, /root/reference/src/gpseval.py:377-417) with a
cumulative-sum formulation; this pins the two as bit-identical on
random walks with injected wraps, gaps, and phase-error steps.
"""

import numpy as np
import pytest

from gps_sdr.config import ReceiverConfig
from gps_sdr.runtime.evaluator import unwrap_code_phases


def _unwrap_loop(cplst, err_stream, prev_tail, cfg, log=None):
    """The original sequential walk (oracle)."""
    diff_tol = 200
    max_diff_no = cfg.n_cyc // 4
    cs = cfg.code_samples
    cpl = list(cplst)
    ovfl = 0
    pno, pcp = cpl[0]
    for i in range(1, len(cpl)):
        no, cp = cpl[i]
        cp += ovfl * cs
        diff = pcp - cp
        if abs(abs(diff) - cs) <= diff_tol:
            cp += np.sign(diff) * cs
            ovfl += np.sign(diff)
        if abs(cp - pcp) > (1 + (no - pno - 1) * 0.2):
            if log is not None:
                log.append(f"{no} [{no-pno}]: code-phase step "
                           f"{abs(cp-pcp):.2f} - possible phase error")
            for j in range(no - pno):
                err_stream[no - j] = err_stream.get(no - j, 0) + 1
        cpl[i] = (no, cp)
        pno, pcp = no, cp
    if cpl and prev_tail is not None:
        no, cp = cpl[0]
        pno, pcp = prev_tail
        if no - pno <= max_diff_no:
            diff = pcp - cp
            if abs(abs(diff) - cs) <= diff_tol:
                cp += np.sign(diff) * cs
            if abs(cp - pcp) > (1 + (no - pno - 1) * 0.2):
                if log is not None:
                    log.append(f"{no} [{no-pno}]: cross-list step "
                               f"{abs(cp-pcp):.2f} - possible phase error")
                for j in range(no - pno):
                    err_stream[no - j] = err_stream.get(no - j, 0) + 1
    return cpl, err_stream


def _random_list(rng, cfg, n, wrap_p=0.15, jump_p=0.05, gap_p=0.1):
    """A code-phase list in raw (wrapped) form with known pathologies."""
    cs = cfg.code_samples
    sno = int(rng.integers(1, 50))
    cp_true = float(rng.uniform(0, cs))
    out = []
    for _ in range(n):
        out.append((sno, cp_true % cs if rng.random() < 0.999 else cp_true))
        sno += 1 + (int(rng.integers(1, 4)) if rng.random() < gap_p else 0)
        cp_true += float(rng.uniform(-0.8, 0.8))
        if rng.random() < jump_p:
            cp_true += float(rng.uniform(5, 400)) * rng.choice([-1, 1])
        if rng.random() < wrap_p:
            # walk across a code-period boundary
            cp_true += cs * float(rng.choice([-1, 1]))
    # raw values stay within [0, cs): re-wrap
    return [(no, cp % cs) for no, cp in out]


@pytest.mark.parametrize("seed", range(8))
def test_unwrap_matches_sequential_walk(seed):
    cfg = ReceiverConfig()
    rng = np.random.default_rng(seed)
    for trial in range(20):
        n = int(rng.integers(1, 40))
        lst = _random_list(rng, cfg, n)
        tail = None
        if rng.random() < 0.5:
            tno = lst[0][0] - int(rng.integers(1, cfg.n_cyc // 4 + 3))
            tail = (tno, float(rng.uniform(-cfg.code_samples,
                                           2 * cfg.code_samples)))
        err_a, err_b = {}, {}
        log_a, log_b = [], []
        got, err_a = unwrap_code_phases(7, lst, err_a, tail, cfg, log_a)
        want, err_b = _unwrap_loop(lst, err_b, tail, cfg, log_b)
        assert len(got) == len(want)
        for (gn, gc), (wn, wc) in zip(got, want):
            assert gn == wn
            assert gc == pytest.approx(wc, abs=1e-9)
        assert err_a == err_b
        assert log_a == log_b
