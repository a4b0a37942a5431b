"""Diagnose the impaired golden-replay fix error: noise or bias?

IMPAIR=0 runs the identical scenario/capture path with the oscillator
model off (isolates the impairment's contribution to the fix bias)."""
import os
import sys

sys.path.insert(0, ".")

import numpy as np  # noqa: E402

from tests.test_impaired_replay import CFG, _capture_path, _scenario  # noqa: E402
from gps_sdr.runtime.session import Session  # noqa: E402
from gps_sdr.runtime.sources import replay_blocks  # noqa: E402
from gps_sdr.utils.geodesy import ecef_to_geo  # noqa: E402


def main():
    if os.environ.get("IMPAIR") == "0":
        import dataclasses

        import tests.test_impaired_replay as tir
        from gps_sdr.models.scenario import make_scenario
        from gps_sdr.models.scenario_jax import DeviceScenarioSynth
        from gps_sdr.runtime.sources import pack_iq
        from tests.conftest import _SYNTH_CACHE

        def _scn0():
            return make_scenario(CFG, n_sats=8,
                                 duration_sec=tir.SEC + 12.0, seed=3)

        def _cap0():
            path = os.path.join(_SYNTH_CACHE, "impaired_capture_v3_osc0.bin")
            if os.path.exists(path):
                return path
            dev = DeviceScenarioSynth(_scn0(), noise_std=0.5)
            n_blocks = int(round(tir.SEC / CFG.block_sec))
            with open(path + ".tmp", "wb") as f:
                done = 0
                while done < n_blocks:
                    k = min(CFG.no_sec, n_blocks - done)
                    pack_iq(0.12 * np.asarray(dev.chunk(done, k))).tofile(f)
                    done += k
            os.replace(path + ".tmp", path)
            return path

        global _capture_path, _scenario
        _capture_path, _scenario = _cap0, _scn0

    path = _capture_path()
    scn = _scenario()
    cfg = CFG
    force_y = os.environ.get("FORCE_Y")
    if force_y is not None:
        import dataclasses
        cfg = dataclasses.replace(CFG, solve_clock_rate=False)
    session = Session(cfg)
    if force_y is not None:
        session.evaluator.clock_rate_est = float(force_y)
    session.run_source(replay_blocks(path, CFG))
    ev = session.evaluator
    mean, dev, n, n_out = ev.stat
    err = np.linalg.norm(mean - scn.rec_ecef)
    print(f"fixes averaged n={n}, outliers={n_out}, "
          f"phase_errors={ev.n_phase_errors}")
    y_true = 1e-6 * (scn.osc_ppm + scn.osc_ppm_rate * 30.0)
    print(f"clock_rate_est {ev.clock_rate_est:.3e}  "
          f"(true y ~ {y_true:.3e})")
    print(f"mean err {err:.2f} m   dev {np.linalg.norm(dev):.2f} m   "
          f"SEM {np.linalg.norm(dev)/np.sqrt(max(n,1)):.2f} m")
    d = mean - scn.rec_ecef
    print(f"ecef bias: {d[0]:+.2f} {d[1]:+.2f} {d[2]:+.2f}")
    lat, lon, h = ecef_to_geo(mean)
    print(f"geo: {lat:.6f} {lon:.6f} h={h:.1f}  (true {scn.rec_geo})")
    # per-fix errors over time
    for t, *p in ev.positions:
        e = np.asarray(p) - scn.rec_ecef
        print(f"  t={t:7.2f}  err={np.linalg.norm(e):6.2f} m  "
              f"({e[0]:+7.2f} {e[1]:+7.2f} {e[2]:+7.2f})")


if __name__ == "__main__":
    main()
