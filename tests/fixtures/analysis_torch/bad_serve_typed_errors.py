"""Seeded violations for the port's ``typed-errors`` rule.

The path contains ``serve`` on purpose: the rule only patrols the serve
layer, where a swallowed broad except becomes a hung stream or an untyped
500. Linted as source, never imported.
"""


class ServeError(RuntimeError):
    pass


def swallowed_wave(run, wave):
    try:
        return run(wave)
    except Exception as e:  # VIOLATION
        return {"error": repr(e)}


def swallowed_teardown(stream):
    try:
        stream.close()
    except BaseException:  # VIOLATION
        pass


def reraised_typed(run):
    try:
        return run()
    except Exception as e:
        raise ServeError(f"replay failed: {e}") from e


def marked(handle, run):
    try:
        return run()
    except Exception as e:  # analysis: fail-fast-ok (delivered to the tenant's stream)
        handle.fail(e)
        return None
