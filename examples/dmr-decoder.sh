#!/bin/bash
# DMR decoding pipeline (digiham_jax equivalent of the reference
# examples/dmr-decoder.sh): FM-demodulated 48 kS/s float samples in.
#
# Requires an SDR front end, e.g.:
#   rtl_fm -f "$1" -M fm -s 48000 | csdr convert -i s16 -o float | csdr dcblock
set -euo pipefail

METAFIFO="${METAFIFO:-/tmp/dmr-meta.fifo}"
[ -p "$METAFIFO" ] || mkfifo "$METAFIFO"

rrc_filter \
  | gfsk_demodulator \
  | dmr_decoder -f "$METAFIFO" \
  | mbe_synthesizer \
  | digitalvoice_filter \
  | play -q -r 8000 -t raw -e signed -b 16 -c 1 -
