"""Plain NumPy references the benchmark judges the program by. Nothing
here imports the program."""
