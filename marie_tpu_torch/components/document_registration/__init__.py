from marie_tpu_torch.components.document_registration.boundary import (
    DocumentBoundaryPrediction,
    DocumentBoundaryRegistration,
)

__all__ = ["DocumentBoundaryRegistration", "DocumentBoundaryPrediction"]
