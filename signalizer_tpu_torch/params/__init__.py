"""The parameter layer of the PyTorch port: ranges, formatters, parameters,
bundles and transformatters (copies of :mod:`signalizer_tpu.params`)."""

from signalizer_tpu_torch.params.parameters import (  # noqa: F401
    Parameter,
    ParameterSet,
    ParameterMap,
    LinearRange,
    ExponentialRange,
    UnityRange,
    BooleanRange,
    IntegerLinearRange,
    BasicFormatter,
    UnitFormatter,
    DBFormatter,
    PercentageFormatter,
    IntegerFormatter,
    BooleanFormatter,
    ChoiceFormatter,
)
from signalizer_tpu_torch.params.values import (  # noqa: F401
    ColourValue,
    WindowDesignValue,
    PowerSlopeValue,
    TransformValue,
)
from signalizer_tpu_torch.params.transformatters import (  # noqa: F401
    AudioHistoryTransformatter,
    WindowSizeTransformatter,
    LinearHzFormatter,
    TimeMode,
)
