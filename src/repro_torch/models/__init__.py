"""The dense llama trunk of the port: layers, attention, the float model
and initialisation."""
