"""Test helpers of the port: fault injection for the checkpoint paths."""

from .fault_injection import CrashPoint, SimulatedCrash, corrupt_file

__all__ = ["CrashPoint", "SimulatedCrash", "corrupt_file"]
