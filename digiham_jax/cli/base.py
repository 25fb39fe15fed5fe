"""CLI framework: the pipe-composable tool skeleton (src/lib/cli.cpp).

Each tool reads a typed binary stream on stdin and writes its output
stream to stdout, exactly like the reference binaries, so digiham_jax
tools drop into existing shell pipelines (examples/*.sh). Decoder tools
add ``-f/--fifo`` for the out-of-band metadata stream
(src/lib/cli.cpp:117-141).
"""
from __future__ import annotations

import argparse
import sys

import numpy as np

from ..runtime.meta import FileMetaWriter

BUF_SIZE = 65536


def default_backend() -> str:
    """Backend for the DSP tools: ``numpy`` (host, reference-exact oracles,
    millisecond startup) or ``jax`` (device path, for batched GPU use).

    The reference binaries start in milliseconds (src/lib/cli.cpp:19-38);
    a shell pipeline user gets the same behavior from the numpy oracles,
    which are bit-exact vs the reference per-sample loops. ``jax`` is the
    opt-in for throughput work. Override with DIGIHAM_CLI_BACKEND.
    """
    import os
    return os.environ.get("DIGIHAM_CLI_BACKEND", "numpy")


class Cli:
    """Base tool: argparse + binary stdin->stdout loop."""

    name = "tool"
    description = ""
    in_dtype = np.uint8
    out_dtype = np.uint8

    def add_arguments(self, parser: argparse.ArgumentParser) -> None:
        pass

    def setup(self, args) -> None:
        pass

    def process(self, data: np.ndarray) -> bytes:
        raise NotImplementedError

    def flush(self) -> bytes:
        return b""

    def main(self, argv=None) -> int:
        parser = argparse.ArgumentParser(
            prog=self.name, description=self.description)
        parser.add_argument("-v", "--version", action="version",
                            version=f"{self.name} (digiham_jax)")
        self.add_arguments(parser)
        args = parser.parse_args(argv)
        self.setup(args)

        stdin = sys.stdin.buffer
        stdout = sys.stdout.buffer
        itemsize = np.dtype(self.in_dtype).itemsize
        carry = b""
        while True:
            chunk = stdin.read(BUF_SIZE)
            if not chunk:
                break
            carry += chunk
            usable = len(carry) - len(carry) % itemsize
            if not usable:
                continue
            data = np.frombuffer(carry[:usable], dtype=self.in_dtype)
            carry = carry[usable:]
            out = self.process(data)
            if out:
                stdout.write(out)
                stdout.flush()
        out = self.flush()
        if out:
            stdout.write(out)
            stdout.flush()
        return 0


class DecoderCli(Cli):
    """Decoder tool: wires a runtime.Decoder + optional metadata fifo
    (src/lib/cli.cpp:117-141)."""

    def make_decoder(self):
        raise NotImplementedError

    def add_arguments(self, parser: argparse.ArgumentParser) -> None:
        parser.add_argument("-f", "--fifo", metavar="PATH",
                            help="send metadata to this file")

    def setup(self, args) -> None:
        self.decoder = self.make_decoder()
        if args.fifo:
            self.decoder.set_meta_writer(FileMetaWriter(args.fifo))

    def process(self, data: np.ndarray) -> bytes:
        return self.decoder.process(data)


def run_tool(tool_cls) -> int:
    return tool_cls().main()
