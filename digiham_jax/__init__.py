"""digiham_jax — many-channel digital-voice decoding on JAX.

A from-scratch JAX/XLA/Pallas re-design of the capabilities of
jketterl/digiham: DMR, YSF, D-Star, NXDN and POCSAG decoding from
FM-demodulated sample streams, including the DSP front end (RRC filtering,
2FSK/4FSK demodulation), all FEC primitives, protocol state machines with
metadata extraction, a codecserver voice bridge, and audio post-filtering —
batched over many channels and shardable over GPU meshes.
"""

__version__ = "0.1.0"

_SUBMODULES = ("fec", "dsp", "protocols", "pipeline", "runtime", "parallel",
               "codec", "cli", "native", "ops", "utils")


def __getattr__(name):
    """Lazy subpackage access: ``import digiham_jax`` stays cheap (no jax
    import) while ``digiham_jax.dsp`` etc. resolve on first touch."""
    if name in _SUBMODULES:
        import importlib

        module = importlib.import_module(f".{name}", __name__)
        globals()[name] = module
        return module
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def __dir__():
    return sorted(list(globals()) + list(_SUBMODULES))
