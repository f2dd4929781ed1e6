"""Receive-side chains: demodulators that invert the tx/ modulators.

The reference project validates its transmitters with real consumer
receivers over the air (/root/reference/README:26-28) — hardware this
environment does not have.  These receivers close that loop in software:
IQ in, transport stream out, through real receiver algorithms (FFT +
pilot-referenced extraction, TPS/L1 decode, Viterbi, Berlekamp-Massey RS,
LDPC/BCH syndrome checks), all device-resident.  They double as the
integration proof that the modulator output is decodable end-to-end.
"""
