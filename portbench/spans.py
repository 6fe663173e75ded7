"""The port's functions that the per-layer metrics wrap in spans, by
layer: "module:attribute" as the path calls them (a module attribute,
looked up at call time, so a wrapper put in its place sees every call).
A metric names the layers it reads in its SPANS; an attribute that no
longer exists leaves those metrics out of the line."""

P = "ecrad_tpu_torch."
ENTRY = {
    "gas_optics": [P + "interface:gas_optics"],
    "aerosol": [P + "interface:add_aerosol_optics"],
    "cloud_optics": [P + "interface:_cloud_stage"],
    "solvers": [P + "interface:solve_lw", P + "interface:solve_sw"],
}
SOLVER = {
    "cloud_generator": [P + "solvers.mcica:_generate"],
    # the LW SPARTACUS solver calls the function through its own name
    "regions": [P + "solvers.tripleclouds:_regions",
                P + "solvers.spartacus_sw:regions_and_overlap",
                P + "solvers.spartacus_lw:regions_and_overlap"],
    "layer_optics": [
        P + "solvers.two_stream:" + f for f in (
            "sw_gammas", "sw_reftrans", "lw_gammas", "lw_reftrans",
            "lw_no_scattering_transmittance")] + [
        P + "solvers.mcica:sw_clear_total_reftrans",
        P + "solvers.mcica:lw_clear_total_noscat",
        P + "solvers.tripleclouds:_region_props_sw_g",
        P + "solvers.spartacus_sw:sw_reftrans_levels",
        P + "solvers.spartacus_lw:lw_reftrans_levels"],
    "sweeps": [P + "solvers.mcica:" + f for f in (
        "adding_sw", "adding_lw", "lw_no_scattering_fluxes")] + [
        P + "solvers.tripleclouds:" + f for f in (
            "adding_sw", "adding_lw", "lw_no_scattering_fluxes",
            "tc_sw_sweeps", "tc_lw_sweeps")] + [
        P + "solvers.spartacus_sw:" + f for f in (
            "sw_adding_sweeps", "adding_sw")] + [
        P + "solvers.spartacus_lw:" + f for f in (
            "lw_adding_sweeps", "adding_lw", "lw_no_scattering_fluxes")],
    "lw_derivatives": [P + "solvers.tripleclouds:lw_derivatives_region",
                       P + "solvers.mcica:lw_derivatives_ica",
                       P + "solvers.spartacus_lw:lw_derivatives_matrix"],
}
#: SPARTACUS's kernels, inside layer_optics (B6, B7) and sweeps (B8, B9):
#: kept out of SOLVER, whose layers solver_other_ms subtracts once each
SPARTACUS = {
    "spartacus_reftrans": [P + "solvers.spartacus_sw:sw_reftrans_levels",
                           P + "solvers.spartacus_lw:lw_reftrans_levels"],
    "spartacus_adding": [P + "solvers.spartacus_sw:sw_adding_sweeps",
                         P + "solvers.spartacus_lw:lw_adding_sweeps"],
}
LAYERS = {**ENTRY, **SOLVER, **SPARTACUS}


def pick(*labels):
    return {label: LAYERS[label] for label in labels}


def per_call_ms(seconds, trace):
    """ms per call; None where the trace holds no device work at all."""
    return seconds / trace.calls * 1e3 if trace.device_ops else None
