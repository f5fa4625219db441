"""The weight bridge (:mod:`.convert`), the ``.npz`` trees
(:mod:`.checkpoints`) and the port's zoo (:mod:`.zoo`).  The JAX
package's ``ModelRegistry`` comes with its module: ROADMAP §1 item 13."""

__all__: list = []
