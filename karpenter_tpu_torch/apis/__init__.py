"""API surface: the data model equivalent of the reference's pkg/apis CRDs."""
