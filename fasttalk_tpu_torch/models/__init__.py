"""Model configs, the Llama forward pass and weight loading."""
