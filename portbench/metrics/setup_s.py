"""setup_s (s, lower is better; host clock): from the process's start to
the window's start: imports, the kernels' build or load, the inputs made
from the seed, the program's set-up and the warm-up of the cell's shapes.
The plain reference's part of set-up (the stored codewords it encodes for
the repair cell) is left out: no change to the program can move it.  A
checkout's first run, which compiles, counts its build."""


def read(rec):
    return rec.setup_s
