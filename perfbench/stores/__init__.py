"""Store kinds: each module builds a configuration's store in the program
and gives the reference the same lineage, rebuilt from the seed."""
