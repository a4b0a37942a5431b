"""Multi-device sharding: mesh construction, sharded acquisition
(Doppler x PRN grid over devices) and sharded tracking (channels over a
mesh axis; long streams over overlap-save time shards with ppermute
boundary stitching).  Replacement for the reference's
process-pool channel fan-out and strictly-sequential stream processing
(src/gpsrecv.py:300-417; SURVEY.md P1/P5/P6)."""

from gps_sdr.parallel.mesh import make_mesh  # noqa: F401
from gps_sdr.parallel.acquisition import acquire_sharded  # noqa: F401
from gps_sdr.parallel.tracking import (  # noqa: F401
    track_sharded, pad_channels)
