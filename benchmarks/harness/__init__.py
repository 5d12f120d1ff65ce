"""The benchmark's general code: files found by name, the closed loop of
jobs, the device trace, the import guard and the checks."""
