"""Test-support code that ships with the port (the seeded chaos
injectors of ``testing.faults``)."""
