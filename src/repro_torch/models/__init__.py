"""Dense llama trunk pieces of the port: layers and initialisation."""
