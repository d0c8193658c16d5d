"""Distillation losses (ref: contrib/slim/distillation/distiller.py).

Port of paddle_tpu/fluid/contrib/slim/distillation/distiller.py. The
reference's DistillationStrategy merges separately-built teacher and
student graphs; here, as in the JAX package, teacher and student are
built in ONE program (the teacher's output marked stop_gradient) and the
distiller appends its loss ops to that program, so the combined step is
one run of one program.
"""
__all__ = ["L2Distiller", "SoftLabelDistiller"]


def _resolve(program, name_or_var):
    from ....framework import Variable

    if isinstance(name_or_var, Variable):
        return name_or_var
    return program.global_block().var(name_or_var)


class L2Distiller:
    """l2 feature-map distillation loss (ref distiller.py:25)."""

    def __init__(self, student_feature_map, teacher_feature_map,
                 distillation_loss_weight=1):
        self.student_feature_map = student_feature_map
        self.teacher_feature_map = teacher_feature_map
        self.distillation_loss_weight = distillation_loss_weight

    def distiller_loss(self, program):
        """Append the l2 loss to `program`; returns the loss Variable."""
        from .... import layers

        from ....framework import program_guard

        with program_guard(program):
            s = _resolve(program, self.student_feature_map)
            t = _resolve(program, self.teacher_feature_map)
            t.stop_gradient = True
            diff = layers.elementwise_sub(s, t)
            loss = layers.reduce_mean(layers.square(diff))
            return layers.scale(
                loss, scale=float(self.distillation_loss_weight))


class SoftLabelDistiller:
    """Soft-label (temperature softmax cross-entropy) distillation loss
    (ref distiller.py:138)."""

    def __init__(self, student_feature_map, teacher_feature_map,
                 student_temperature=1.0, teacher_temperature=1.0,
                 distillation_loss_weight=1):
        self.student_feature_map = student_feature_map
        self.teacher_feature_map = teacher_feature_map
        self.student_temperature = student_temperature
        self.teacher_temperature = teacher_temperature
        self.distillation_loss_weight = distillation_loss_weight

    def distiller_loss(self, program):
        from .... import layers
        from ....framework import program_guard

        with program_guard(program):
            s = _resolve(program, self.student_feature_map)
            t = _resolve(program, self.teacher_feature_map)
            t.stop_gradient = True
            s_soft = layers.softmax(layers.scale(
                s, scale=1.0 / float(self.student_temperature)))
            t_soft = layers.softmax(layers.scale(
                t, scale=1.0 / float(self.teacher_temperature)))
            ce = layers.cross_entropy(s_soft, t_soft, soft_label=True)
            return layers.scale(
                layers.reduce_mean(ce),
                scale=float(self.distillation_loss_weight))
