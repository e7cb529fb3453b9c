"""The reference's four examples on the port, one module each
(``python -m repro_torch.examples.<name>``; ``--device cpu`` runs one
without a card). Each ``main(device=None)`` prints the reference
example's lines and returns the numbers it prints."""
