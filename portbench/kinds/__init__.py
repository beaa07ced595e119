"""One module per kind of work a traffic mix names (`"kind"`): it builds
the program's objects for a configuration, warms up, serves one request at
a time, reads the program's counters and judges the window's results
against the plain reference."""
