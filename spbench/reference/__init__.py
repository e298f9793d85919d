"""The plain reference that decides `correct`: each stencil applied by
shifted slices of its zero-padded grid, and a textbook CG over that
apply.  Plain torch only: it imports nothing of the program and takes
nothing the program made, only the configuration's stencils and the
inputs the benchmark drew."""
