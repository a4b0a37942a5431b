"""utils/profiling trace reduction on small recorded traces: device
busy time is the union of a device's lane intervals, and a trace with no
device lane (a CPU run) is refused rather than read as device time."""

import gzip
import json
import os

import pytest

from gps_sdr.utils.profiling import (device_time_from_trace,
                                     op_breakdown_from_trace)


def _write(tmp_path, events):
    d = tmp_path / "plugins" / "profile" / "run"
    os.makedirs(d)
    with gzip.open(d / "perfetto_trace.json.gz", "wt") as f:
        json.dump({"traceEvents": events}, f)


def _meta(pid, name):
    return {"ph": "M", "name": "process_name", "pid": pid,
            "args": {"name": name}}


def _op(pid, tid, ts, dur, name):
    return {"ph": "X", "pid": pid, "tid": tid, "ts": ts, "dur": dur,
            "name": name}


def test_gpu_lanes_union(tmp_path):
    _write(tmp_path, [
        _meta(1, "/device:GPU:0"), _meta(7, "/host:CPU"),
        _op(1, 13, 0.0, 10.0, "fusion"),
        _op(1, 14, 5.0, 10.0, "fft"),          # overlaps on another stream
        _op(1, 13, 30.0, 5.0, "fusion"),
        _op(7, 1, 0.0, 1000.0, "PjitFunction"),  # host: never counted
    ])
    dev = device_time_from_trace(str(tmp_path))
    assert dev["device"] == "/device:GPU:0"
    assert dev["busy_s"] == pytest.approx(20e-6)
    assert dev["span_s"] == pytest.approx(35e-6)
    assert dev["n_ops"] == 3 and dev["n_lanes"] == 2
    ops = op_breakdown_from_trace(str(tmp_path))
    assert ops[0][0] == "fusion" and ops[0][2] == 2


def test_cpu_trace_is_refused(tmp_path):
    _write(tmp_path, [_meta(7, "/host:CPU"),
                      _op(7, 1, 0.0, 50.0, "fusion")])
    with pytest.raises(RuntimeError, match="no device lane"):
        device_time_from_trace(str(tmp_path))
    with pytest.raises(RuntimeError, match="no device lane"):
        op_breakdown_from_trace(str(tmp_path))
