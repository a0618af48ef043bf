"""The plain reference: numpy lineage constructors, the workflows built from
them, and hash-join propagation over explicit lineage pairs.  It imports
nothing of the program."""
