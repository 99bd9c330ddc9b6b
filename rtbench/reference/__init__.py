"""The plain reference: plain torch, importing nothing of the program."""
