"""BER-vs-SNR parity curves: compiled reference chain vs ours, all five
protocols (BASELINE.md north-star metric "BER vs reference").

Per (protocol, SNR, seed): synthesize a clean stream, add calibrated
AWGN, then decode the SAME noisy samples through

  reference:  dsp_harness rrc[-narrow] -> dsp_harness gfsk/fsk
              -> ref_harness <protocol>           (its own full chain)
  ours:       full device pipeline (our RRC -> demod -> decoder
              -> TrackedChannelBank)              (our own full chain)

Unlike tools/fuzz_fullchain.py (which feeds the reference RRC output to
both sides to get byte-exactness), each side here runs its OWN RRC —
this measures the end-to-end divergence rate of the ~1e-5 f32 filter
difference at realistic SNR, closing the "our-RRC-vs-ref-RRC divergence
study" gap.

Reported per SNR point (aggregated over seeds):
  - ser_ref / ser_ours: demod symbol error rate vs the transmitted
    symbols (alignment-searched; pad/silence symbols excluded)
  - payload_match: fraction of cases where the two chains' payload
    byte streams are identical
  - ties: payload mismatches classified as float-precision knife edges
    by fuzz_fullchain.is_precision_tie (timing/slicer ties, not logic)

Writes docs/BER_PARITY.json and prints a markdown table.

Usage: python tools/ber_parity.py [seeds_per_point] [out.json]
"""
import json
import os
import subprocess
import sys

import numpy as np

sys.path.insert(0, "tests")
sys.path.insert(0, ".")
sys.path.insert(0, "tools")

os.environ.setdefault("JAX_PLATFORMS", "cpu")
import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

from fuzz_fullchain import (  # noqa: E402
    DEMOD_ARGS,
    DSP,
    FOUR_LEVELS,
    PROTOCOLS,
    TWO_LEVELS,
    is_precision_tie,
    our_chain,
    ref_chain,
    synth,
)

SNRS_DB = (4, 6, 8, 10, 12, 16, 20, 30)


def our_chain_full(protocol, samples, chunk=16384):
    """Our full chain INCLUDING our RRC front end (use_rrc=True)."""
    from digiham_jax.pipeline import (DmrPipeline, FskPipeline,
                                      NxdnPipeline, YsfPipeline)
    from digiham_jax.runtime.meta import PipelineMetaWriter
    from digiham_jax.runtime.tracked_bank import (DmrAdapter,
                                                  DstarAdapter,
                                                  NxdnAdapter,
                                                  PocsagAdapter,
                                                  TrackedChannelBank,
                                                  YsfAdapter)

    if protocol == "dmr":
        pipe = DmrPipeline(channels=1, sps=10, n_centuries=2)
        adapter = DmrAdapter()
    elif protocol == "ysf":
        pipe = YsfPipeline(channels=1, sps=10, n_centuries=10)
        adapter = YsfAdapter()
    elif protocol == "nxdn":
        pipe = NxdnPipeline(channels=1, sps=20, n_centuries=4)
        adapter = NxdnAdapter()
    elif protocol == "dstar":
        pipe = FskPipeline(channels=1, protocol="dstar", n_centuries=2)
        adapter = DstarAdapter()
    else:
        pipe = FskPipeline(channels=1, protocol="pocsag", n_centuries=2)
        adapter = PocsagAdapter()
    out = {0: b""}
    bank = TrackedChannelBank(
        pipe, on_output=lambda c, d: out.__setitem__(0, out[0] + d),
        adapter=adapter)
    events = []
    bank.set_meta_writer(0, PipelineMetaWriter(
        lambda b: events.append(b.decode("utf-8", "surrogateescape"))))
    row = samples[None, :].astype(np.float32)
    for lo in range(0, row.shape[1], chunk):
        bank.push(row[:, lo:lo + chunk])
    bank.flush()
    return out[0], "".join(events)


def ref_demod(protocol, samples):
    """Reference front end only: own RRC (4FSK protocols) + demod."""
    x = samples
    if protocol in ("dmr", "ysf", "nxdn"):
        mode = "rrc-narrow" if protocol == "nxdn" else "rrc"
        p = subprocess.run([DSP, mode], input=x.tobytes(),
                           capture_output=True, timeout=300)
        assert p.returncode == 0, p.stderr[-200:]
        x = np.frombuffer(p.stdout, np.float32)
    p = subprocess.run([DSP] + DEMOD_ARGS[protocol], input=x.tobytes(),
                       capture_output=True, timeout=300)
    assert p.returncode == 0, p.stderr[-200:]
    return np.frombuffer(p.stdout, np.uint8)


def our_demod(protocol, samples):
    """Our front end only: our RRC (4FSK) + device demod block."""
    import jax.numpy as jnp

    from digiham_jax.dsp.demod import (demod_init, fsk_demod_block,
                                       gfsk_demod_block)
    from digiham_jax.dsp.rrc import (NARROW_RRC, WIDE_RRC, RrcState,
                                     rrc_filter_block)

    sps = {"dmr": 10, "ysf": 10, "nxdn": 20, "dstar": 10,
           "pocsag": 40}[protocol]
    x = jnp.asarray(samples, jnp.float32)[None, :]
    if protocol in ("dmr", "ysf", "nxdn"):
        design = NARROW_RRC if protocol == "nxdn" else WIDE_RRC
        x, _ = rrc_filter_block(x, RrcState.init(1, design), design)
    n_cent = (x.shape[1] // sps - 2) // 100
    if n_cent < 1:
        return np.zeros(0, np.uint8)
    if protocol in ("dstar", "pocsag"):
        sym, _ = fsk_demod_block(x, demod_init(1), n_cent, sps,
                                 protocol == "pocsag")
    else:
        sym, _ = gfsk_demod_block(x, demod_init(1), n_cent, sps)
    return np.asarray(sym)[0].astype(np.uint8)


def tx_symbols(protocol, clean, sps):
    """Recover the transmitted symbol stream from the clean baseband
    (synth builds it as repeat(levels[sym], sps)); silence marked -1."""
    v = clean[::sps][:len(clean) // sps]
    if protocol in ("dstar", "pocsag"):
        levels = -TWO_LEVELS if protocol == "pocsag" else TWO_LEVELS
    else:
        levels = FOUR_LEVELS
    d = np.abs(v[:, None] - levels[None, :])
    sym = d.argmin(1).astype(np.int64)
    sym[np.abs(v) < 1e-6] = -1  # zero padding / silence
    return sym


def ser(rx, tx):
    """Symbol error rate vs tx with alignment search (RRC group delay +
    demod slew); silence (-1) excluded."""
    best = 1.0
    valid = tx >= 0
    if valid.sum() == 0 or len(rx) == 0:
        return 1.0
    for off in range(0, 30):
        n = min(len(rx) - off, len(tx))
        if n <= 0:
            break
        m = valid[:n]
        if m.sum() == 0:
            continue
        err = float(np.mean(rx[off:off + n][m] != tx[:n][m]))
        best = min(best, err)
    return best


def run_point(protocol, snr_db, seed):
    rng = np.random.default_rng(seed)
    clean, sps = synth(protocol, rng)
    tx = tx_symbols(protocol, clean, sps)
    amp = 1000.0
    p_sig = float(np.mean(clean[np.abs(clean) > 1e-6] ** 2))
    sigma = np.sqrt(p_sig / (10 ** (snr_db / 10)))
    noisy = ((clean + rng.normal(0, sigma, len(clean))) * amp
             ).astype(np.float32)

    rx_ref = ref_demod(protocol, noisy)
    rx_ours = our_demod(protocol, noisy)
    ser_ref = ser(rx_ref, tx)
    ser_ours = ser(rx_ours, tx)

    filt_ref = _ref_rrc(protocol, noisy)
    pay_ref, _ = ref_chain(DEMOD_ARGS[protocol], protocol, filt_ref)
    pay_ours, _ = our_chain_full(protocol, noisy)
    match = pay_ours == pay_ref
    # byte agreement: positional, over the shorter stream
    n = min(len(pay_ref), len(pay_ours))
    if n:
        agree = float(np.mean(np.frombuffer(pay_ref[:n], np.uint8)
                              == np.frombuffer(pay_ours[:n], np.uint8)))
    else:
        agree = 1.0 if len(pay_ref) == len(pay_ours) else 0.0
    # attribute a mismatch: RRC f32 envelope (our decoder on the
    # ref-RRC stream matches), precision tie, or logic divergence
    cause = "match"
    if not match:
        ours_on_ref, _ = our_chain(protocol, filt_ref, 16384)
        if ours_on_ref == pay_ref:
            cause = "rrc_envelope"
        elif is_precision_tie(protocol, filt_ref):
            cause = "precision_tie"
        else:
            cause = "logic"
    return {"ser_ref": ser_ref, "ser_ours": ser_ours,
            "len_ref": len(pay_ref), "len_ours": len(pay_ours),
            "match": bool(match), "byte_agree": agree, "cause": cause}


def _ref_rrc(protocol, noisy):
    if protocol not in ("dmr", "ysf", "nxdn"):
        return noisy
    mode = "rrc-narrow" if protocol == "nxdn" else "rrc"
    p = subprocess.run([DSP, mode], input=noisy.tobytes(),
                       capture_output=True, timeout=300)
    assert p.returncode == 0
    return np.frombuffer(p.stdout, np.float32)


def main(seeds_per_point=4, out_path="docs/BER_PARITY.json"):
    results = []
    for proto in PROTOCOLS:
        for snr in SNRS_DB:
            pts = [run_point(proto, snr, 1000 * snr + s)
                   for s in range(seeds_per_point)]
            causes = [p["cause"] for p in pts]
            agg = {
                "protocol": proto,
                "snr_db": snr,
                "ser_ref": round(float(np.mean([p["ser_ref"]
                                                for p in pts])), 5),
                "ser_ours": round(float(np.mean([p["ser_ours"]
                                                 for p in pts])), 5),
                "payload_match": sum(p["match"] for p in pts),
                "byte_agree": round(float(np.mean(
                    [p["byte_agree"] for p in pts])), 5),
                "rrc_envelope": causes.count("rrc_envelope"),
                "precision_ties": causes.count("precision_tie"),
                "logic_divergences": causes.count("logic"),
                "cases": len(pts),
                "ref_bytes": sum(p["len_ref"] for p in pts),
                "our_bytes": sum(p["len_ours"] for p in pts),
            }
            results.append(agg)
            print(f"{proto:7s} {snr:3d} dB  ser_ref={agg['ser_ref']:.4f} "
                  f"ser_ours={agg['ser_ours']:.4f} "
                  f"match={agg['payload_match']}/{agg['cases']} "
                  f"agree={agg['byte_agree']:.4f} "
                  f"rrc={agg['rrc_envelope']} tie={agg['precision_ties']} "
                  f"logic={agg['logic_divergences']}", flush=True)
        jax.clear_caches()
    os.makedirs(os.path.dirname(out_path), exist_ok=True)
    with open(out_path, "w") as f:
        json.dump({"snrs_db": list(SNRS_DB),
                   "seeds_per_point": seeds_per_point,
                   "results": results}, f, indent=1)
    print(f"\nwrote {out_path}")
    # markdown table for docs
    print("\n| protocol | SNR dB | SER ref | SER ours | payload match | "
          "byte agree | cause of mismatch |")
    print("|---|---|---|---|---|---|---|")
    for r in results:
        cause = (f"rrc:{r['rrc_envelope']} tie:{r['precision_ties']} "
                 f"logic:{r['logic_divergences']}")
        print(f"| {r['protocol']} | {r['snr_db']} | {r['ser_ref']} | "
              f"{r['ser_ours']} | {r['payload_match']}/{r['cases']} | "
              f"{r['byte_agree']} | {cause} |")


if __name__ == "__main__":
    args = sys.argv[1:]
    main(int(args[0]) if args else 4,
         args[1] if len(args) > 1 else "docs/BER_PARITY.json")
