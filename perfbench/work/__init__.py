"""The model's work, counted from a configuration file's ``model`` section and
the traffic's shapes: useful FLOPs and least bytes.  Nothing here reads the
program; the counts are of the model, not of how the program computes it."""
