"""Paper core, ported: plant, PI controller, energy accounting and the
closed-loop simulation front end (`sim.simulate_closed_loop`,
`sim.sweep`)."""
