"""The plain reference the benchmark holds the program to: GF(2^8) over
0x11D, the CP-Azure and CP-Uniform constructions, encode and decode, and
the contiguous placement. It imports nothing of the code under test."""
