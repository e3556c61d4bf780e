"""Ternary codec, packing formats and the CIM linear layer."""
