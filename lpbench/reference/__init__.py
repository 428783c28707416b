"""The plain checker that decides ``correct`` (NumPy only, no program imports)."""

from lpbench.reference.check import NUMBERS, lane_numbers, program_operands, verdict, worst

__all__ = ["NUMBERS", "lane_numbers", "program_operands", "verdict", "worst"]
