"""The port's CLIs (``python -m moleculesde_tpu_torch.examples.<name>``)."""


def note_inert_flags(given: dict) -> None:
    """Print one line for each flag of ``given`` ({flag: whether it was
    set}) that is set: the JAX package's shared parser gives the CLI that
    flag and the CLI does nothing with it, nor does the port's."""
    for flag, asked in given.items():
        if asked:
            print(f"{flag} has no effect in this CLI (the JAX CLI parses it and "
                  f"does nothing with it)")
