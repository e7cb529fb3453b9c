"""Batched serving with power-controlled decode (memory-bound phase);
port of `examples/serve_batched.py`.

Decode barely responds to compute power (the roofline says HBM-bound), so
the controller harvests energy at small epsilon. Compare controlled vs
uncontrolled energy. The power figures are those of the simulated
``v5e-chip`` plant (`serve --plant`'s default, caps 90-250 W) that the
NRM drives, not the card's: nothing here sets the card's power limit.

Run:  PYTHONPATH=src python -m repro_torch.examples.serve_batched [--device cpu]
"""
from __future__ import annotations

from repro_torch import resolve_device
from repro_torch.examples._cli import device_arg
from repro_torch.launch import serve

ARCH = "starcoder2-3b"    # served `--reduced`, weights and prompts of seed 0
BATCH, PROMPT_LEN, GEN = 4, 64, 96
BASE_ARGV = ["--arch", ARCH, "--reduced", "--batch", str(BATCH),
             "--prompt-len", str(PROMPT_LEN), "--gen", str(GEN), "--quiet"]
POWER_ARGV = ["--power", "--epsilon", "0.15"]


def main(device=None) -> dict:
    """Serves the same batch without and with the NRM; returns both
    `serve.main` results."""
    dev = resolve_device(device)
    off = serve.main(BASE_ARGV, device=dev)
    on = serve.main(BASE_ARGV + POWER_ARGV, device=dev)
    print(f"uncontrolled: {off['tok_per_s_sim']:.0f} tok/s")
    print(f"controlled  : {on['tok_per_s_sim']:.0f} tok/s, "
          f"energy={on['energy_j']:.0f} J, final pcap={on['final_pcap']} W")
    return {"off": off, "on": on}


if __name__ == "__main__":
    main(device_arg(__doc__))
