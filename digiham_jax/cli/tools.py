"""The ten pipe-composable tools (reference src/*/\\*_cli.cpp).

Same names, same stream dtypes, same flags — a digiham user can swap
these into examples/*.sh pipelines unchanged.
"""
from __future__ import annotations


import sys
import threading

import numpy as np

from ..utils import enable_compilation_cache
from .base import Cli, DecoderCli, default_backend


def _add_backend_arg(parser):
    parser.add_argument("--backend", choices=("numpy", "jax"),
                        default=default_backend(),
                        help="numpy: host oracle, instant startup "
                             "(default); jax: device path")


def _jnp():
    import jax.numpy as jnp
    return jnp


class RrcFilterCli(Cli):
    """float -> float RRC filter (src/rrc_filter/rrc_filter_cli.cpp)."""

    name = "rrc_filter"
    description = "root-raised-cosine channel filter"
    in_dtype = np.float32
    out_dtype = np.float32

    def add_arguments(self, parser):
        parser.add_argument("-n", "--narrow", action="store_true",
                            help="use narrow (6.25 kHz) filter")
        _add_backend_arg(parser)

    def setup(self, args):
        from ..dsp.rrc import NARROW_RRC, WIDE_RRC
        self.design = NARROW_RRC if args.narrow else WIDE_RRC
        if args.backend == "numpy":
            from ..dsp.rrc import RrcStreamNp
            self.stream = RrcStreamNp(self.design)
        else:
            enable_compilation_cache()
            from ..dsp.rrc import RrcState, rrc_filter
            self.stream = None
            self.state = RrcState.init(1, self.design)
            self.filter = rrc_filter

    def process(self, data: np.ndarray) -> bytes:
        if self.stream is not None:
            return self.stream.process(data).tobytes()
        jnp = _jnp()
        y, self.state = self.filter(
            jnp.asarray(data)[None, :], self.state, self.design)
        return np.asarray(y)[0].astype(np.float32).tobytes()


class _OracleStream:
    """Streaming adapter over the reference-exact per-symbol oracles
    (FskDemodNp/GfskDemodNp): buffers samples, demodulates what's ready,
    trims consumed input. The oracle's ``pos`` only moves forward (the
    advance is ``sps + variance_offset`` with offset in {-1,0,+1} and the
    read window starts at ``pos``), so trimming to ``pos`` is safe."""

    def __init__(self, oracle):
        self.oracle = oracle
        self.buf = np.zeros(0, np.float32)

    def push(self, samples: np.ndarray) -> np.ndarray:
        self.buf = np.concatenate(
            [self.buf, np.asarray(samples, np.float32)])
        out = self.oracle.process(self.buf)
        self.buf = self.buf[self.oracle.pos:]
        self.oracle.pos = 0
        return out


class _DemodCli(Cli):
    in_dtype = np.float32
    out_dtype = np.uint8
    default_sps = 10

    def add_arguments(self, parser):
        parser.add_argument("-s", "--samples", type=int,
                            default=self.default_sps,
                            help="samples per symbol")
        _add_backend_arg(parser)

    def _setup_driver(self, args, demod_fn):
        """numpy backend: drive the oracle directly (instant startup,
        bit-exact vs the reference per-sample loop). jax backend: the
        device StreamDriver century pipeline."""
        cls, invert = self._oracle
        if args.backend == "numpy":
            self.driver = None
            self.stream = _OracleStream(cls(args.samples, invert=invert))
            return
        enable_compilation_cache()
        from ..dsp.demod import demod_init
        from ..runtime.stream import StreamDriver
        self.driver = StreamDriver(1, args.samples, demod_fn, demod_init(1),
                                   n_centuries=1)

    def process(self, data: np.ndarray) -> bytes:
        if self.driver is None:
            return self.stream.push(data).astype(np.uint8).tobytes()
        jnp = _jnp()
        blocks = self.driver.push(np.asarray(data, np.float32)[None, :])
        return b"".join(np.asarray(b)[0].astype(np.uint8).tobytes()
                        for b in blocks)

    _oracle = None  # (cls, invert) set by subclasses in setup

    def flush(self) -> bytes:
        """EOF: the device path needs full centuries; demodulate the
        buffered tail with the reference-exact per-symbol oracle seeded
        from the (century-aligned) device carry, so the tool loses only
        the reference's own sps+1 lookahead at end of input. The numpy
        backend already consumed to within that lookahead."""
        if self._oracle is None or self.driver is None:
            return b""
        cls, invert = self._oracle
        drv = self.driver
        st = drv.state
        o = cls(drv.sps, invert=invert)
        o.pos = int(np.asarray(st.pos)[0])
        o.variance_offset = int(np.asarray(st.offset)[0])
        o.volume_rb = np.asarray(st.volume_ring)[0].astype(
            np.float32).copy()
        tail = drv.buffer.data[0, :drv.buffer.fill]
        return o.process(tail).astype(np.uint8).tobytes()


class FskDemodulatorCli(_DemodCli):
    """2FSK (src/fsk_demodulator/fsk_demodulator_cli.cpp), default 40 sps."""

    name = "fsk_demodulator"
    description = "2FSK demodulator (bits out)"
    default_sps = 40

    def add_arguments(self, parser):
        super().add_arguments(parser)
        parser.add_argument("-i", "--invert", action="store_true",
                            help="invert bit polarity")

    def setup(self, args):
        from ..dsp.demod import FskDemodNp, fsk_demod_block
        invert = args.invert
        self._oracle = (FskDemodNp, invert)

        def fn(block, state, n_centuries):
            return fsk_demod_block(block, state, n_centuries, args.samples,
                                   invert)

        self._setup_driver(args, fn)


class GfskDemodulatorCli(_DemodCli):
    """4FSK (src/gfsk_demodulator/gfsk_demodulator_cli.cpp), 10 sps."""

    name = "gfsk_demodulator"
    description = "4FSK (GFSK/C4FM) demodulator (dibits out)"
    default_sps = 10

    def setup(self, args):
        from ..dsp.demod import GfskDemodNp, gfsk_demod_block
        self._oracle = (GfskDemodNp, False)

        def fn(block, state, n_centuries):
            return gfsk_demod_block(block, state, n_centuries, args.samples)

        self._setup_driver(args, fn)


class DigitalVoiceFilterCli(Cli):
    """s16 audio post filter (src/digitalvoice_filter/)."""

    name = "digitalvoice_filter"
    description = "200-3400 Hz bandpass for digital voice audio"
    in_dtype = np.int16
    out_dtype = np.int16

    def add_arguments(self, parser):
        _add_backend_arg(parser)

    def setup(self, args):
        if args.backend == "numpy":
            from ..dsp.audio import DigitalVoiceFilterNp
            self.oracle = DigitalVoiceFilterNp()
            return
        enable_compilation_cache()
        from ..dsp.audio import DigitalVoiceState, digitalvoice_filter
        self.oracle = None
        self.state = DigitalVoiceState.init(1)
        self.filter = digitalvoice_filter

    def process(self, data: np.ndarray) -> bytes:
        if self.oracle is not None:
            return self.oracle.process(data).tobytes()
        jnp = _jnp()
        y, self.state = self.filter(jnp.asarray(data)[None, :], self.state)
        return np.asarray(y)[0].astype(np.int16).tobytes()


class DmrDecoderCli(DecoderCli):
    """(src/dmr_decoder/dmr_cli.cpp) with runtime slot-filter control."""

    name = "dmr_decoder"
    description = "DMR decoder (dibits in, voice frames out)"

    def make_decoder(self):
        from ..protocols.dmr import make_decoder
        return make_decoder()

    def add_arguments(self, parser):
        super().add_arguments(parser)
        parser.add_argument("-c", "--control-fifo", metavar="PATH",
                            help="read slot filter commands (0-3) from "
                                 "this fifo")

    def setup(self, args):
        super().setup(args)
        if args.control_fifo:
            t = threading.Thread(target=self._fifo_loop,
                                 args=(args.control_fifo,), daemon=True)
            t.start()

    def _fifo_loop(self, path):
        """(dmr_cli.cpp:57-78)"""
        try:
            with open(path, "r") as f:
                for line in f:
                    line = line.strip()
                    if line.isdigit():
                        flt = int(line)
                        if 0 <= flt <= 3:
                            self.decoder.set_slot_filter(flt)
                        else:
                            print(f"invalid slot filter: {flt}",
                                  file=sys.stderr)
        except OSError as e:
            print(f"error reading control fifo: {e}", file=sys.stderr)


class YsfDecoderCli(DecoderCli):
    name = "ysf_decoder"
    description = "YSF decoder"

    def make_decoder(self):
        from ..protocols.ysf import make_decoder
        return make_decoder()


class DstarDecoderCli(DecoderCli):
    name = "dstar_decoder"
    description = "D-Star decoder (bits in)"

    def make_decoder(self):
        from ..protocols.dstar import make_decoder
        return make_decoder()


class NxdnDecoderCli(DecoderCli):
    name = "nxdn_decoder"
    description = "NXDN decoder"

    def make_decoder(self):
        from ..protocols.nxdn import make_decoder
        return make_decoder()


class PocsagDecoderCli(DecoderCli):
    name = "pocsag_decoder"
    description = "POCSAG pager decoder (bits in, messages out)"

    def add_arguments(self, parser):
        pass  # POCSAG writes messages into the payload stream; no fifo

    def setup(self, args):
        self.decoder = self.make_decoder()

    def make_decoder(self):
        from ..protocols import pocsag
        return pocsag.make_decoder()


class MbeSynthesizerCli(Cli):
    """(src/mbe_synthesizer/cli.cpp): AMBE frames in -> s16 PCM out via
    codecserver; --yaesu enables in-stream mode switching."""

    name = "mbe_synthesizer"
    description = "MBE voice synthesizer (requires codecserver)"
    in_dtype = np.uint8
    out_dtype = np.int16

    def add_arguments(self, parser):
        parser.add_argument("-y", "--yaesu", action="store_true",
                            help="YSF mode (in-stream codec switching)")
        parser.add_argument("-d", "--dstar", action="store_true",
                            help="D-Star compatible codec")
        parser.add_argument("-s", "--server",
                            default="/tmp/codecserver.sock",
                            help="codecserver unix path or host:port")
        parser.add_argument("-t", "--test", action="store_true",
                            help="test if codecserver can supply AMBE")

    def setup(self, args):
        from ..codec import (ControlWordMode, DynamicMode, MbeSynthesizer,
                             TableMode)
        from ..codec.modes import (DMR_NXDN_TABLE_INDEX,
                                   DSTAR_CONTROL_WORDS, ysf_mode_for)
        server = args.server
        if ":" in server and "/" not in server:
            host, port = server.rsplit(":", 1)
            synth = MbeSynthesizer(host, int(port),
                                   pcm_sink=self._pcm_out)
        else:
            synth = MbeSynthesizer(server, pcm_sink=self._pcm_out)
        if args.test:
            ok = synth.has_ambe_codec()
            print("server response ok" if ok else "no ambe codec",
                  file=sys.stderr)
            synth.close()
            raise SystemExit(0 if ok else 1)
        if args.yaesu:
            synth.set_mode(DynamicMode(ysf_mode_for))
        elif args.dstar:
            synth.set_mode(ControlWordMode(DSTAR_CONTROL_WORDS))
        else:
            synth.set_mode(TableMode(DMR_NXDN_TABLE_INDEX))
        self.synth = synth

    @staticmethod
    def _pcm_out(pcm: bytes) -> None:
        sys.stdout.buffer.write(pcm)
        sys.stdout.buffer.flush()

    def process(self, data: np.ndarray) -> bytes:
        self.synth.process(data.tobytes())
        return b""  # PCM flows via the reader-thread sink


def rrc_filter_main():
    return RrcFilterCli().main()


def fsk_demodulator_main():
    return FskDemodulatorCli().main()


def gfsk_demodulator_main():
    return GfskDemodulatorCli().main()


def digitalvoice_filter_main():
    return DigitalVoiceFilterCli().main()


def dmr_decoder_main():
    return DmrDecoderCli().main()


def ysf_decoder_main():
    return YsfDecoderCli().main()


def dstar_decoder_main():
    return DstarDecoderCli().main()


def nxdn_decoder_main():
    return NxdnDecoderCli().main()


def pocsag_decoder_main():
    return PocsagDecoderCli().main()


def mbe_synthesizer_main():
    return MbeSynthesizerCli().main()
