"""Reduction-op constants, the same wire names as the JAX package."""

Sum = "sum"
Average = "average"
Adasum = "adasum"
Min = "min"
Max = "max"
