"""The plain float32 references the judge holds the program to: frozen
copies that import nothing of the program."""
