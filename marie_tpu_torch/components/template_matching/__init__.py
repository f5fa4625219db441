from marie_tpu_torch.components.template_matching.base import (
    BaseTemplateMatcher,
    TemplateMatchResult,
)
from marie_tpu_torch.components.template_matching.composite import CompositeTemplateMatcher
from marie_tpu_torch.components.template_matching.dim_matcher import (
    DIMTemplateMatcher,
    VQNNFTemplateMatcher,
)
from marie_tpu_torch.components.template_matching.document_matched import (
    OcrConditionedMatcher,
)
from marie_tpu_torch.components.template_matching.ncc_matcher import NCCTemplateMatcher

__all__ = [
    "BaseTemplateMatcher",
    "TemplateMatchResult",
    "NCCTemplateMatcher",
    "CompositeTemplateMatcher",
    "DIMTemplateMatcher",
    "VQNNFTemplateMatcher",
    "OcrConditionedMatcher",
]
