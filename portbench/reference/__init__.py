"""Plain reference of the benchmark cells: no code of the program."""
