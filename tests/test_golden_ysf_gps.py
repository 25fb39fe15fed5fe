"""Golden YSF GPS: DT1/DT2 data frames carrying a short-GPS report,
compared byte-for-byte against the reference (float math + formatting)."""
import os
import sys

import numpy as np
import pytest

sys.path.insert(0, os.path.dirname(__file__))

from test_golden_reference import compare

# every test here runs the compiled reference: skip, not fail, when the
# reference source tree is absent (tests/conftest.py)
pytestmark = pytest.mark.usefixtures("ref_harness")
from ysf_synth import vd2_frame, terminator_frame


def gps_payload():
    """Valid Yaesu short-GPS bytes (gps.cpp semantics): 42°17.24'N
    71°09.005'W."""
    b = [0] * 9
    for i, d in enumerate([4, 2, 1, 7, 2, 4]):
        b[i] = d
    b[3] |= 0x50  # northern hemisphere
    b[4] |= 0x30  # longitude range marker
    b[5] |= 0x50  # western hemisphere
    b[6] = 0x63   # 10 + (0x63-0x26) = 71 degrees
    b[7] = 0x58 + 9
    b[8] = 0x1C + 30
    return bytes(b)


def dt_frames():
    """DT1 (frame 6) + DT2 (frame 7) carrying a short-GPS data frame."""
    data = bytearray(20)
    data[1:4] = (0x22625F).to_bytes(3, "big")
    data[4] = 0x2B  # FT-70D
    data[5:14] = gps_payload()
    data[18] = 0x03
    data[19] = sum(data[:19]) & 0xFF
    return (vd2_frame(6, bytes(data[:10])),
            vd2_frame(7, bytes(data[10:20])))


class TestYsfGpsGolden:
    def test_gps_metadata_identical(self, tmp_path):
        from digiham_jax.protocols.ysf import make_decoder
        d1, d2 = dt_frames()
        frames = [vd2_frame(0, b"CALLSIGN  "), d1, d2,
                  terminator_frame(), terminator_frame()]
        stream = np.concatenate(frames)
        compare("ysf", make_decoder, stream, tmp_path)

    @pytest.mark.parametrize("seed", range(5))
    def test_random_gps_bytes(self, seed, tmp_path):
        """Random (mostly invalid) GPS payloads: validity checks and float
        decode paths must agree exactly."""
        from digiham_jax.protocols.ysf import make_decoder
        rng = np.random.default_rng(seed)
        data = bytearray(20)
        data[1:4] = (0x22625F).to_bytes(3, "big")
        data[4:18] = bytes(rng.integers(0, 256, 14).tolist())
        data[18] = 0x03
        data[19] = sum(data[:19]) & 0xFF
        frames = [vd2_frame(0, b"RANDOMGPS "),
                  vd2_frame(6, bytes(data[:10])),
                  vd2_frame(7, bytes(data[10:20])),
                  terminator_frame(), terminator_frame()]
        stream = np.concatenate(frames)
        compare("ysf", make_decoder, stream, tmp_path)
