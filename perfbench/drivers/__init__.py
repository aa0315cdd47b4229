"""One driver per configuration kind (``kind`` in the configuration's
file): it builds the program's entry from the cell, warms it up, times
the window, traces it, and holds what it produced to the reference."""
