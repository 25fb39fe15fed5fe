"""Pre-populate the persistent jit cache for the CLI tools' jax backend.

The CLI tools default to the numpy oracle backend (millisecond startup,
reference-exact); `DIGIHAM_CLI_BACKEND=jax` opts into the device path,
whose first run pays the jit compile. Running this once per machine (or
in an image build / postinstall step) drives the ACTUAL CLI classes —
same argparse surface, same stdin chunk sizes as the real read loop —
so the compiled shapes in the persistent cache ($JAX_COMPILATION_CACHE_DIR,
else <checkout>/.jax_cache — digiham_jax.utils.compilation_cache_dir)
are exactly the ones the tools execute.

Configurations covered (the examples/*.sh pipelines):
  rrc_filter (wide) and rrc_filter -n (narrow)
  gfsk_demodulator -s 10 (DMR/YSF) and -s 20 (NXDN48)
  fsk_demodulator  -s 10 (D-Star) and -s 40 -i (POCSAG)
  digitalvoice_filter

Usage: python tools/warm_cli_cache.py [--platform cpu]
"""
import argparse
import os
import sys
import time

sys.path.insert(0, ".")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--platform", default=None,
                    help="pin the jax platform (e.g. 'cpu'); default "
                         "uses the session backend — the cache is "
                         "platform-specific, so warm on the platform "
                         "the CLIs will run on")
    args = ap.parse_args()
    if args.platform:
        os.environ["JAX_PLATFORMS"] = args.platform

    from digiham_jax.utils import enable_compilation_cache
    cache = enable_compilation_cache()

    import numpy as np
    from digiham_jax.cli.base import BUF_SIZE
    from digiham_jax.cli.tools import (DigitalVoiceFilterCli,
                                       FskDemodulatorCli,
                                       GfskDemodulatorCli, RrcFilterCli)

    configs = [
        (RrcFilterCli, []),
        (RrcFilterCli, ["--narrow"]),
        (GfskDemodulatorCli, ["-s", "10"]),
        (GfskDemodulatorCli, ["-s", "20"]),
        (FskDemodulatorCli, ["-s", "10"]),
        (FskDemodulatorCli, ["-s", "40", "--invert"]),
        (DigitalVoiceFilterCli, []),
    ]
    t0 = time.time()
    for cls, argv in configs:
        tool = cls()
        parser = argparse.ArgumentParser(prog=tool.name)
        tool.add_arguments(parser)
        ns = parser.parse_args(argv + ["--backend", "jax"])
        tool.setup(ns)
        # the real read loop delivers BUF_SIZE bytes per chunk; push two
        # chunks so block-boundary code paths compile too
        chunk = BUF_SIZE // np.dtype(tool.in_dtype).itemsize
        data = np.zeros(chunk, tool.in_dtype)
        tool.process(data)
        tool.process(data)
        print(f"{tool.name} {' '.join(argv) or '(default)'}: warm "
              f"({time.time() - t0:.1f}s)", flush=True)
    print(f"cache at {cache} ready in {time.time() - t0:.1f}s")


if __name__ == "__main__":
    main()
